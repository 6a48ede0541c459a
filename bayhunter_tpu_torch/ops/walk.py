"""K2: the warm Rayleigh root walker — CUDA kernel and plain twin.

Mirrors ``bayhunter_tpu/ops/pallas_walk.py`` (``_walk_kernel``,
``warm_roots_walk``) on the transposed-layout path with the model
kernel's stacked planes.  One lane per (chain, period):

  1. Newton recentering of the warm start: ``newton_iters`` passes, the
     first from the cached bracket slope when one is given (0.0 =
     no-cache sentinel: no shift) or else a DDC/16 finite difference,
     later passes a secant across the previous step; each shift is
     clipped to ``newton_maxshift`` and the start to [cm, bx];
  2. the walk: candidates +1, -1, +2, -2, ... DDC from the start, at
     most 2 ring_k trips probes; a sign change against the side's
     frontier sign brackets the root; a lane dies once both sides have
     left [cm, bx + DDC];
  3. ``nbisect`` bisections of the bracket, then the closing secant
     with the smaller-|f| endpoint fallback; the bracket's slope is
     returned as the next solve's cache (0.0 where unfound).

The secular function is the Dunkin recursion of
``pallas_secular._dltar4_layer_math`` from each chain's own deepest
layer ``top`` up (the JAX kernel uses its tile's maximum; the skipped
identity layers change values only by a positive scale, so signs and
found flags do not change), plus the water-surface clause.
"""

import torch

from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import swd as _swd


def _layer(e, wvno, wvno2, omega, d_l, a_l, b_l, rho_l):
    """One Dunkin layer update, renormalised by its max-abs entry."""
    xka = omega / a_l
    xkb = omega / b_l
    ra = _swd._vertical(wvno, xka)
    rb = _swd._vertical(wvno, xkb)
    t_l = b_l / omega
    gammk = 2.0 * t_l * t_l
    gam = gammk * wvno2
    cosp, w, x, pex = _swd._var_quantities(ra * d_l, ra, wvno < xka, d_l)
    cosq, y, z, sex = _swd._var_quantities(rb * d_l, rb, wvno < xkb, d_l)
    exa = pex + sex
    a0 = torch.where(exa < 60.0, torch.exp(-exa), torch.zeros_like(exa))
    n = _swd._dnka_apply(e, wvno2, gam, gammk, rho_l, a0, cosp * cosq,
                         cosp * y, cosp * z, cosq * w, cosq * x, x * y,
                         x * z, w * y, w * z)
    a = [torch.abs(v) for v in n]
    nrm = torch.maximum(torch.maximum(a[0], a[1]),
                        torch.maximum(torch.maximum(a[2], a[3]), a[4]))
    nrm = torch.where(nrm < 1e-40, torch.ones_like(nrm), nrm)
    inv = 1.0 / nrm
    return tuple(v * inv for v in n)


def secular_plain(c, omega, props, top):
    """Secular values at (C, R) candidates ``c``; ``props`` (4 NL, C)
    planes [d; a; b; rho]; ``top`` (C,) deepest active layer."""
    nl = props.shape[0] // 4
    d, a, b, rho = (props[k * nl:(k + 1) * nl].T[:, :, None]
                    for k in range(4))                  # (C, NL, 1)
    top = torch.clamp(top.to(torch.int64), max=nl - 2)[:, None]
    wvno = omega / c
    wvno2 = wvno * wvno
    water = b[:, 0] <= 0.0
    e = _swd._halfspace(wvno, wvno2, omega, a[:, nl - 1], b[:, nl - 1],
                        rho[:, nl - 1])
    for l in range(int(top.max().item()) if top.numel() else -1, -1, -1):
        new = _layer(e, wvno, wvno2, omega, d[:, l], a[:, l], b[:, l],
                     rho[:, l])
        keep = top < l
        if l == 0:
            keep = keep | water
        e = tuple(torch.where(keep, eo, en) for eo, en in zip(e, new))
    xka0 = omega / a[:, 0]
    ra0 = _swd._vertical(wvno, xka0)
    cosp_w, w_w, _, _ = _swd._var_quantities(ra0 * d[:, 0], ra0,
                                             wvno < xka0, d[:, 0])
    return torch.where(water, cosp_w * e[0] - rho[:, 0] * w_w * e[1],
                       e[0])


def warm_roots_walk_plain(props, omegas, c_prev, cm, bx, top, ring_k,
                          trips, nbisect, newton_iters, newton_maxshift,
                          slope_prev=None):
    """Plain PyTorch twin of the walker kernel (same arguments and
    results as :func:`warm_roots_walk`)."""
    dc = torch.tensor(_swd.DDC, dtype=torch.float32, device=props.device)
    eps = dc / 16.0
    ms = float(newton_maxshift)
    cm = cm[:, None]
    bx = bx[:, None]
    omega = torch.clamp(omegas, min=1.0e-4)[None, :].expand_as(c_prev)

    def sec(c):
        return secular_plain(c, omega, props, top)

    def clip(x):
        return torch.minimum(torch.maximum(x, cm), bx)

    one = torch.ones_like(c_prev)
    c0 = clip(c_prev)
    if newton_iters > 0:
        v0 = sec(c0)
        if slope_prev is not None:
            hasf = torch.where(torch.abs(slope_prev) > 0.0, one, 0.0 * one)
            slope = torch.where(hasf > 0.5, slope_prev, one)
        else:
            hasf = one
            slope = (sec(c0 + eps) - v0) / eps
            slope = torch.where(slope == 0.0, one, slope)
        shift = torch.clamp(-v0 / slope, -ms, ms) * hasf
        c_pv, v_pv = c0, v0
        c0 = clip(c0 + shift)
        for _ in range(newton_iters - 1):
            v0 = sec(c0)
            step = c0 - c_pv
            secant = (v0 - v_pv) / torch.where(step == 0.0, one, step)
            slope = torch.where(torch.abs(step) > eps, secant, slope)
            slope = torch.where(slope == 0.0, one, slope)
            shift = torch.clamp(-v0 / slope, -ms, ms) * hasf
            c_pv, v_pv = c0, v0
            c0 = clip(c0 + shift)

    f0 = sec(c0)
    s_r = s_l = f0 > 0
    f_r = f_l = f0
    found = torch.zeros_like(s_r)
    dead = torch.zeros_like(s_r)
    lo = cm.expand_as(c0).clone()
    hi = lo + dc
    f_lo = f_hi = f0
    for t in range(2 * ring_k * trips):
        if bool((found | dead).all()):
            break
        k = torch.tensor(float(t // 2 + 1), device=props.device) * dc
        right = t % 2 == 0
        if right:
            cand = c0 + k
            valid = cand <= bx + dc
        else:
            cand = c0 - k
            valid = cand >= cm
        f = sec(cand)
        s = f > 0
        s_prev, f_prev = (s_r, f_r) if right else (s_l, f_l)
        flip = (s != s_prev) & valid & ~found & ~dead
        lo = torch.where(flip, cand - dc if right else cand, lo)
        hi = torch.where(flip, cand if right else cand + dc, hi)
        f_lo = torch.where(flip, f_prev if right else f, f_lo)
        f_hi = torch.where(flip, f if right else f_prev, f_hi)
        found = found | flip
        if right:
            s_r = torch.where(valid, s, s_r)
            f_r = torch.where(valid, f, f_r)
        else:
            s_l = torch.where(valid, s, s_l)
            f_l = torch.where(valid, f, f_l)
            dead = dead | (((c0 + k) > bx + dc) & ((c0 - k) < cm))
    for _ in range(nbisect):
        mid = 0.5 * (lo + hi)
        fm = sec(mid)
        same = (fm > 0) == (f_lo > 0)
        up_lo = found & same
        up_hi = found & ~same
        lo = torch.where(up_lo, mid, lo)
        f_lo = torch.where(up_lo, fm, f_lo)
        hi = torch.where(up_hi, mid, hi)
        f_hi = torch.where(up_hi, fm, f_hi)
    c, slope = _swd.secant_close(lo, hi, f_lo, f_hi)
    return c, found, torch.where(found, slope, torch.zeros_like(slope))


def warm_roots_walk(props, omegas, c_prev, cm, bx, top, ring_k, trips,
                    nbisect, newton_iters, newton_maxshift,
                    slope_prev=None):
    """Warm root solve of every (chain, period) lane.

    ``props`` (4 NL, C) walker planes [d; a; b; rho] and ``cm``/``bx``/
    ``top`` (C,) from the model kernel; ``omegas`` (R,) angular
    frequencies; ``c_prev``/``slope_prev`` (C, R) cached roots and
    slopes.  Returns (root, found, slope), each (C, R).  CPU tensors
    run the plain twin; CUDA tensors launch the kernel."""
    if props.device.type == 'cpu':
        return warm_roots_walk_plain(props, omegas, c_prev, cm, bx, top,
                                     ring_k, trips, nbisect,
                                     newton_iters, newton_maxshift,
                                     slope_prev)
    dev = props.device
    C, R = c_prev.shape
    nl = props.shape[0] // 4
    f32 = torch.float32
    _ext.require(props, 'props', dev, f32, (4 * nl, C))
    _ext.require(omegas, 'omegas', dev, f32, (R,))
    _ext.require(c_prev, 'c_prev', dev, f32, (C, R))
    for name, x in (('cm', cm), ('bx', bx), ('top', top)):
        _ext.require(x, name, dev, f32, (C,))
    if slope_prev is not None:
        _ext.require(slope_prev, 'slope_prev', dev, f32, (C, R))
    c = torch.empty((C, R), dtype=f32, device=dev)
    found = torch.empty((C, R), dtype=torch.bool, device=dev)
    slope = torch.empty((C, R), dtype=f32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_walk(
            _ext.ptr(props), _ext.ptr(omegas), _ext.ptr(c_prev),
            _ext.ptr(cm), _ext.ptr(bx), _ext.ptr(top),
            _ext.ptr(slope_prev), nl, C, R, 2 * ring_k * trips,
            nbisect, newton_iters, float(newton_maxshift),
            int(slope_prev is not None), _ext.ptr(c), _ext.ptr(found),
            _ext.ptr(slope), _ext.stream(dev))
    _ext.check(rc, 'walk')
    warm_roots_walk.launches += 1
    return c, found, slope


warm_roots_walk.launches = 0
