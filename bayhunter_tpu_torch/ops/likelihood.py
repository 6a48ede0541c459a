"""Gaussian log-likelihood laws (torch) and the host whitener (numpy).

Mirrors ``bayhunter_tpu/ops/likelihood.py``: ``rms``,
``loglike_nocorr``, ``loglike_nocorr_scalederr``, ``loglike_exp``,
``loglike_gauss``, ``loglike_gauss_white``, ``loglike_gauss_white_dof``,
``gauss_whitener`` and the correlation matrices.  Every law returns
``logL = -0.5 (n log 2pi + log|C|) - madist/2`` over the last axis of
``ydiff``; ``sigma`` broadcasts against the leading (chain) axes.
"""

import numpy as np
import torch

LOG2PI = float(np.log(2.0 * np.pi))


def rms(yobs, ymod):
    """Root-mean-square misfit over the last axis
    (reference: src/Targets.py:100-103)."""
    return torch.sqrt(torch.mean((ymod - yobs) ** 2, dim=-1))


def _assemble(n, logc_det, madist):
    return -0.5 * (n * LOG2PI + logc_det) - 0.5 * madist


def loglike_nocorr(ydiff, sigma):
    """Uncorrelated noise, identity correlation."""
    n = ydiff.shape[-1]
    madist = torch.sum(ydiff * ydiff, dim=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * torch.log(sigma)
    return _assemble(n, logc_det, madist)


def loglike_nocorr_scalederr(ydiff, sigma, scaled_err, log_scalederr_sum):
    """Uncorrelated noise with relatively scaled data errors:
    ``scaled_err = yerr / min(yerr)`` and ``log_scalederr_sum =
    sum(log(scaled_err))`` are host constants of the observed data."""
    n = ydiff.shape[-1]
    madist = torch.sum(ydiff * ydiff / scaled_err, dim=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * torch.log(sigma) + log_scalederr_sum
    return _assemble(n, logc_det, madist)


def loglike_exp(ydiff, sigma, corr):
    """Exponential correlation law r^|i-j| through its analytic
    tridiagonal inverse, matrix-free:
    C^-1 = tridiag(diag = [1, 1+r^2, ..., 1+r^2, 1], off = -r)
    / (sigma^2 (1-r^2)), log|C| = 2n log sigma + (n-1) log(1-r^2).
    ``corr`` broadcasts like ``sigma`` (one value per chain)."""
    n = ydiff.shape[-1]
    d2 = ydiff * ydiff
    s_all = torch.sum(d2, dim=-1)
    s_int = torch.sum(d2[..., 1:-1], dim=-1)
    s_cross = torch.sum(ydiff[..., :-1] * ydiff[..., 1:], dim=-1)
    quad = s_all + corr * corr * s_int - 2.0 * corr * s_cross
    madist = quad / (sigma * sigma * (1.0 - corr * corr))
    logc_det = (2.0 * n) * torch.log(sigma) \
        + (n - 1) * torch.log(1.0 - corr * corr)
    return _assemble(n, logc_det, madist)


def loglike_gauss(ydiff, sigma, corr_inv, logcorr_det):
    """Gaussian correlation law r^((i-j)^2) through the dense inverse
    ``corr_inv`` (n, n) of the correlation matrix and its
    log-determinant ``logcorr_det``, both from
    :func:`init_covariance_gauss` (reference: src/Targets.py:150-173).
    The sampler takes :func:`loglike_gauss_white`, whose quadratic form
    cannot round negative in float32."""
    n = ydiff.shape[-1]
    madist = torch.einsum('...i,ij,...j->...', ydiff, corr_inv, ydiff) \
        / (sigma * sigma)
    logc_det = (2.0 * n) * torch.log(sigma) + logcorr_det
    return _assemble(n, logc_det, madist)


def _whiten(ydiff, whitener, wide):
    """``ydiff @ whitener``, through ``wide(fn, ydiff)`` when given (the
    evaluator's: a split run's worker computes the product at the
    one-device run's width, whose matrix-product kernel sets the
    rounding of each row)."""
    if wide is None:
        return ydiff @ whitener
    return wide(lambda d: d @ whitener, ydiff)


def loglike_gauss_white(ydiff, sigma, whitener, logcorr_det, wide=None):
    """Gaussian correlation law through the whitening factor ``W``
    (n, k), ``C^-1 ~ W W^T``: the quadratic form is a sum of squares,
    so it cannot round negative in float32."""
    n = ydiff.shape[-1]
    w = _whiten(ydiff, whitener, wide)
    madist = torch.sum(w * w, dim=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * torch.log(sigma) + logcorr_det
    return _assemble(n, logc_det, madist)


def loglike_gauss_white_dof(ydiff, sigma, whitener, logdet_kept,
                            wide=None):
    """Degrees-of-freedom-corrected Gaussian law on the k kept
    eigen-directions (normalised by k and the kept log-determinant)."""
    k = whitener.shape[-1]
    w = _whiten(ydiff, whitener, wide)
    madist = torch.sum(w * w, dim=-1) / (sigma * sigma)
    logc_det = (2.0 * k) * torch.log(sigma) + logdet_kept
    return _assemble(k, logc_det, madist)


def gauss_correlation_matrix(corr, size):
    """R[i, j] = corr ** ((i - j) ** 2)."""
    idx = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
    return np.asarray(corr) ** (idx ** 2)


def init_covariance_gauss(corr, size, rcond=None):
    """Dense inverse (or pinv with rcond) and log-determinant of the
    Gaussian correlation matrix, computed once per inversion on the
    host (``Targets.Valuation``; reference: src/Targets.py:150-160)."""
    rmatrix = gauss_correlation_matrix(corr, size)
    if rcond is not None:
        corr_inv = np.linalg.pinv(rmatrix, rcond=rcond)
    else:
        corr_inv = np.linalg.inv(rmatrix)
    _, logdet = np.linalg.slogdet(rmatrix)
    return corr_inv, float(logdet)


def exp_correlation_matrix(corr, size):
    """R[i, j] = corr ** |i - j| (synthetic noise draws)."""
    idx = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
    return np.asarray(corr) ** idx


def gauss_whitener(corr, size, rcond=None, return_kept=False):
    """Whitening factor W (n, k) = U diag(1/sqrt(lambda)) over the
    eigenvalues kept by the rcond truncation; returns (W, log|R|) or,
    with ``return_kept``, (W, sum log lambda_kept)."""
    rmatrix = gauss_correlation_matrix(corr, size)
    lam, u = np.linalg.eigh(rmatrix)
    if rcond is not None:
        keep = lam > rcond * lam.max()
    else:
        keep = lam > 0
    w = u[:, keep] / np.sqrt(lam[keep])
    if return_kept:
        return w, float(np.sum(np.log(lam[keep])))
    _, logdet = np.linalg.slogdet(rmatrix)
    return w, float(logdet)
