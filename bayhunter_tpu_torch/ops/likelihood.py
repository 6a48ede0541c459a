"""Gaussian log-likelihood laws (torch) and the host whitener (numpy).

Mirrors ``bayhunter_tpu/ops/likelihood.py``: ``loglike_nocorr``,
``loglike_gauss_white``, ``loglike_gauss_white_dof`` and
``gauss_whitener``.  Every law returns
``logL = -0.5 (n log 2pi + log|C|) - madist/2`` over the last axis of
``ydiff``; ``sigma`` broadcasts against the leading (chain) axes.
"""

import numpy as np
import torch

LOG2PI = float(np.log(2.0 * np.pi))


def _assemble(n, logc_det, madist):
    return -0.5 * (n * LOG2PI + logc_det) - 0.5 * madist


def loglike_nocorr(ydiff, sigma):
    """Uncorrelated noise, identity correlation."""
    n = ydiff.shape[-1]
    madist = torch.sum(ydiff * ydiff, dim=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * torch.log(sigma)
    return _assemble(n, logc_det, madist)


def loglike_gauss_white(ydiff, sigma, whitener, logcorr_det):
    """Gaussian correlation law through the whitening factor ``W``
    (n, k), ``C^-1 ~ W W^T``: the quadratic form is a sum of squares,
    so it cannot round negative in float32."""
    n = ydiff.shape[-1]
    w = ydiff @ whitener
    madist = torch.sum(w * w, dim=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * torch.log(sigma) + logcorr_det
    return _assemble(n, logc_det, madist)


def loglike_gauss_white_dof(ydiff, sigma, whitener, logdet_kept):
    """Degrees-of-freedom-corrected Gaussian law on the k kept
    eigen-directions (normalised by k and the kept log-determinant)."""
    k = whitener.shape[-1]
    w = ydiff @ whitener
    madist = torch.sum(w * w, dim=-1) / (sigma * sigma)
    logc_det = (2.0 * k) * torch.log(sigma) + logdet_kept
    return _assemble(k, logc_det, madist)


def gauss_correlation_matrix(corr, size):
    """R[i, j] = corr ** ((i - j) ** 2)."""
    idx = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
    return np.asarray(corr) ** (idx ** 2)


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
