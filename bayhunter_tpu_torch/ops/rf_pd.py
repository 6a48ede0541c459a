"""Linearized RF inversion: exact partial derivatives and truncated-SVD
Gauss-Newton steps.

Mirrors ``bayhunter_tpu/ops/rf_pd.py``, the working form of rfmini's
dormant partial-derivative path (greens.cpp:592-680, pd.cpp:5-31):

  * the Jacobian of the receiver function with respect to each layer's
    vs is exact forward-mode autodiff (``torch.func.jvp``, vmapped over
    the rows of :func:`_parameter_basis`) through the port's real-plane
    RF forward: the plain twins of K6 and K3/K3r
    (``prep.rf_operands_plain``, ``rf.transmission_response(_q)``), the
    Z/R rotation, the spectral division and the inverse FFT over all
    nsamp/2 + 1 frequencies, as the JAX package differentiates its XLA
    ``synrf``, with no Pallas kernel on that path.  The kernels carry
    no tangents, so on CUDA tensors this module runs PyTorch
    operations and no hand-written kernel;
  * a vs change moves vp at the layer's vp/vs ratio and rho through a
    selectable density law (``FlatLayer::perturb``, model.cpp:169-192;
    ``_rho_law``);
  * the solve is a truncated-SVD least squares with ``svbksb``
    semantics (``torch.linalg.svd``) and optional Levenberg damping.

Models batch over a leading axis natively: (NL,) arrays for one model,
(B, NL) for B.
"""

import torch

from bayhunter_tpu_torch.ops import rf as _rf
from bayhunter_tpu_torch.ops.rf import P_WAVE, rho_vp


def _rho_law(rho_coupling, rho0):
    """Density riding along a vp change: 'bayhunter' = the sampler's
    0.32 vp + 0.77, 'berteussen' = the full rfmini relation
    (:func:`rf.rho_vp`), 'fixed' = rho frozen at the input."""
    if rho_coupling == 'bayhunter':
        return lambda vp_p: 0.32 * vp_p + 0.77
    if rho_coupling == 'berteussen':
        return rho_vp
    if rho_coupling == 'fixed':
        return lambda vp_p: rho0
    raise ValueError('unknown rho_coupling %r' % (rho_coupling,))


def _parameter_basis(h, dtype):
    """Tangent basis (..., NL, NL) of (..., NL) thicknesses: row k is the
    slot direction moved by parameter k.  Finite layers map one to one;
    the halfspace parameter (the row of the first zero-thickness slot)
    moves every trailing padded slot together, since the padding
    replicates the halfspace there and a lone zero-thickness slot is
    invisible to the response; the other padded rows are zero
    (``bayhunter_tpu/ops/rf_pd.py`` ``_parameter_basis``)."""
    nl = h.shape[-1]
    finite = h > 0
    idx = torch.arange(nl, device=h.device)
    pad = ~finite
    k0 = torch.argmax(pad.to(torch.int8), dim=-1)[..., None, None]
    hs = ((idx[:, None] == k0) & (idx[None, :] >= k0)
          & pad.any(dim=-1)[..., None, None])
    return torch.diag_embed(finite.to(dtype)) + hs.to(dtype)


def _forward(h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp, fsamp, tshift,
             nsv, poisson, wave_type, flattening):
    """RF (B, nsamp) of (B, NL) models through the plain twins."""
    rotated, series = _rf._rotated_spectra(
        h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp, fsamp, tshift, nsv,
        poisson, wave_type, _rf.FREF, flattening, vs.device,
        cut=nsamp // 2 + 1, plain=True)
    return series(*_rf.divide(*rotated))


def rf_partials(h, vp, vs, qp, qs, p_sdeg, gauss_a, nsamp, fsamp, tshift,
                nsv, poisson, wave_type=P_WAVE, first=0, nused=None,
                flattening=True, rho_coupling='bayhunter', rho=None):
    """Receiver function and its exact vs-Jacobian.

    Arguments mirror :func:`bayhunter_tpu_torch.ops.rf.synrf` (``qp``,
    ``qs`` arrays of the models' shape or scalars; ``nsv``,
    ``poisson`` per model or scalars); ``h``, ``vp``, ``vs`` (NL,) or
    (B, NL) tensors; ``first`` / ``nused`` select the sample window
    (greens.cpp:701-702).

    Returns ``(rf_win, J)``: ``rf_win`` (..., nused) and ``J[..., i, k]
    = d rf[first + i] / d vs-parameter k`` (..., nused, NL), where a
    change of parameter k carries vp (fixed vp/vs) and rho (the
    ``rho_coupling`` law) along; parameter k < n-1 is layer k's vs, the
    parameter at the first zero-thickness slot the halfspace vs (see
    :func:`_parameter_basis`); the other padded columns are zero."""
    if nused is None:
        nused = nsamp - first
    vs = torch.as_tensor(vs)
    dt, dev = vs.dtype, vs.device
    single = vs.dim() == 1

    def tensor(x, model_axis=True):
        """``x`` on ``vs``'s dtype and device with a leading model axis
        (``model_axis``); None and scalars as they are."""
        if x is None or isinstance(x, (int, float)):
            return x
        x = torch.as_tensor(x, dtype=dt, device=dev)
        return x[None] if single and model_axis else x

    h, vp, vs, qp, qs, rho = (tensor(x) for x in (h, vp, vs, qp, qs, rho))
    nsv, poisson = (tensor(x, False) for x in (nsv, poisson))
    ratio = vp / torch.where(vs > 0, vs, torch.ones_like(vs))
    rho_of = _rho_law(rho_coupling, rho)

    def fwd(vs_p):
        vp_p = ratio * vs_p
        out = _forward(h, vp_p, vs_p, rho_of(vp_p), qp, qs, p_sdeg,
                       gauss_a, nsamp, fsamp, tshift, nsv, poisson,
                       wave_type, flattening)
        return out[:, first:first + nused]

    basis = _parameter_basis(h, dt)                     # (B, NL, NL)
    rf_win = fwd(vs)
    jt = torch.func.vmap(lambda t: torch.func.jvp(fwd, (vs,), (t,))[1],
                         in_dims=1)(basis)              # (NL, B, nused)
    J = jt.permute(1, 2, 0)
    return (rf_win[0], J[0]) if single else (rf_win, J)


def truncated_svd_solve(J, resid, rcond=1e-4, damping=0.0):
    """Least-squares step ``dx`` (..., NL) minimizing ``|J dx - resid|``
    for ``J`` (..., n, NL): ``svbksb`` semantics (pd.cpp:5-31), singular
    components with s <= rcond * s_max dropped, and Levenberg damping
    s / (s^2 + (damping s_max)^2) of the kept ones."""
    U, s, Vt = torch.linalg.svd(J, full_matrices=False)
    smax = s.amax(dim=-1, keepdim=True)
    keep = s > rcond * smax
    d2 = (damping * smax) ** 2
    inv_s = torch.where(keep, s / (s * s + d2), torch.zeros_like(s))
    coef = inv_s * (U.transpose(-1, -2) @ resid[..., None])[..., 0]
    return (Vt.transpose(-1, -2) @ coef[..., None])[..., 0]


def invert_rf(rf_obs, h, vp, vs, qp, qs, p_sdeg, gauss_a, nsamp, fsamp,
              tshift, nsv, poisson, wave_type=P_WAVE, first=0, nused=None,
              flattening=True, niter=6, rcond=1e-4, damping=0.05,
              dvs_max=0.25, vs_min=0.1, rho_coupling='bayhunter', rho=None):
    """Damped Gauss-Newton refinement of the layer vs profile against an
    observed receiver function ``rf_obs`` (..., n).

    Each iteration evaluates :func:`rf_partials` and takes a
    truncated-SVD step, clipped to ``dvs_max`` km/s per parameter and
    floored at ``vs_min``; vp and rho follow vs as in
    ``FlatLayer::perturb``.  Returns ``(vs_out, rms_trace)``, the latter
    (..., niter) holding each iteration's residual RMS before its step.
    A leading axis of ``rf_obs``, ``h``, ``vp``, ``vs`` (and of array
    ``qp``, ``qs``, ``nsv``, ``poisson``, ``rho``) batches models."""
    vs = torch.as_tensor(vs)
    dt, dev = vs.dtype, vs.device
    rf_obs, h, vp = (torch.as_tensor(x, dtype=dt, device=dev)
                     for x in (rf_obs, h, vp))
    if nused is None:
        nused = min(rf_obs.shape[-1], nsamp) - first
    basis = _parameter_basis(h, dt)
    obs_win = rf_obs if rf_obs.shape[-1] == nused \
        else rf_obs[..., first:first + nused]
    vs_cur, rms = vs, []
    for _ in range(niter):
        rf_win, J = rf_partials(
            h, vp * (vs_cur / vs), vs_cur, qp, qs, p_sdeg, gauss_a, nsamp,
            fsamp, tshift, nsv, poisson, wave_type=wave_type, first=first,
            nused=nused, flattening=flattening, rho_coupling=rho_coupling,
            rho=rho)
        resid = obs_win - rf_win
        rms.append(torch.sqrt(torch.mean(resid * resid, dim=-1)))
        dp = truncated_svd_solve(J, resid, rcond=rcond, damping=damping)
        # parameter steps spread back to the slots: the halfspace
        # parameter moves every trailing padded copy
        dvs = (torch.clamp(dp, -dvs_max, dvs_max)[..., None, :]
               @ basis)[..., 0, :]
        vs_cur = torch.clamp(vs_cur + dvs, min=vs_min)
    return vs_cur, torch.stack(rms, dim=-1)
