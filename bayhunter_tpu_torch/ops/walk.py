"""K2: the warm root walker, Rayleigh and Love — CUDA kernel and plain
twin.

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

The secular function (``swd.secular_plain``) is the Dunkin recursion
of ``pallas_secular._dltar4_layer_math`` plus the water-surface clause
for Rayleigh (``iwave`` 2), the Haskell SH recursion of
``_dltar1_layer_math`` for Love (``iwave`` 1), from each chain's own
deepest layer ``top`` up (the JAX kernel uses its tile's maximum; the
skipped identity layers change values only by a positive scale, so
signs and found flags do not change).  Both read the model kernel's
Rayleigh planes: on a flat earth Love's [d; b; rho] are planes 0, 2 and
3 of that stack, and cm, betmx and top are the same for both.  On a
spherical earth the flattened d, b, cm, betmx and top are shared too,
but the density is not (exponent -5 against -2.275,
``pallas_prep.py:285``): a spherical Love target passes K1's Love
density plane as ``rho``, which replaces plane 3.  A group target's
lanes are the 2P periods t / (1 +- HGR) (``swd.lane_periods``) with 12
bisections; the kernel sees lanes only.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import lanes as _lanes
from bayhunter_tpu_torch.ops import swd as _swd

MAX_THREADS = 128   # a block's threads (csrc/walk.cu WALK_MAX_THREADS)


class Geometry(NamedTuple):
    """Launch geometry of the walker: ``threads`` per block, ``tile``
    whole chains per block, ``blocks``, dynamic shared bytes ``smem``."""
    threads: int
    tile: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=64)
def geometry(C, R, nl, iwave):
    """The walker's launch geometry for C chains of R periods and nl
    layer slots (csrc/walk.cu's shared-memory layout): a tile of
    ``threads // R`` chains (at least one) per block, so that a block's
    lanes are whole chains; fewer threads where the per-thread invariant
    columns would not fit."""
    ninv = 3 if iwave == 2 else 2
    threads = MAX_THREADS
    while True:
        tile = max(1, threads // R)
        floats = 4 * nl * tile + 2 * tile + ninv * (nl - 1) * threads
        smem = 4 * (floats + 2 * tile)             # + top and order ints
        if smem <= _lanes.SMEM_MAX or threads == _lanes.WARP:
            break
        threads //= 2
    if smem > _lanes.SMEM_MAX:
        raise ValueError('walker: %d layer slots need %d bytes of shared '
                         'memory, above %d' % (nl, smem, _lanes.SMEM_MAX))
    return Geometry(threads, tile, -(-C // tile), smem)


def lane_map(geo, C, R, top):
    """(blocks, rounds, threads) int64: the lane ``chain * R + period``
    that each thread of each block serves in each round, -1 where it
    idles — the kernel's map, the tile's chains ordered by (top, chain).
    ``top`` (C,) clamped deepest slots."""
    T, tile, B = geo.threads, geo.tile, geo.blocks
    key = np.full(B * tile, np.iinfo(np.int64).max)
    key[:C] = np.asarray(top, np.int64)
    order = np.argsort(key.reshape(B, tile), axis=1, kind='stable')
    rounds = -(-tile * R // T)
    j = np.arange(rounds * T)
    cc = order[:, np.minimum(j // R, tile - 1)]
    lanes = (np.arange(B)[:, None] * tile + cc) * R + j % R
    tc = np.minimum(tile, C - np.arange(B) * tile)
    lanes[j[None, :] >= (tc * R)[:, None]] = -1
    return lanes.reshape(B, rounds, T)


def lane_work(C, R, nl, iwave, top, evaluations):
    """(executed, useful) layer-evaluations of a launch under the
    kernel's lane map (:func:`lanes.executed_work`): ``evaluations``
    (C, R) per lane (``warm_roots_walk_plain.evaluations``), each
    running the chain's layers top..0."""
    top = np.minimum(np.asarray(top, np.int64), nl - 2)
    layers = np.repeat(top + 1, R)
    lm = lane_map(geometry(C, R, nl, iwave), C, R, top)
    return _lanes.executed_work(lm, evaluations, layers)


def warm_roots_walk_plain(props, omegas, c_prev, cm, bx, top, ring_k,
                          trips, nbisect, newton_iters, newton_maxshift,
                          slope_prev=None, iwave=2, rho=None):
    """Plain PyTorch twin of the walker kernel (same arguments and
    results as :func:`warm_roots_walk`).  Leaves the number of secular
    evaluations the kernel makes for each lane, (C, R) int32, in
    ``warm_roots_walk_plain.evaluations`` (the work a bound on the
    kernel's time counts)."""
    dc = torch.tensor(_swd.DDC, dtype=torch.float32, device=props.device)
    eps = dc / 16.0
    ms = float(newton_maxshift)
    cm = cm[:, None]
    bx = bx[:, None]
    omega = torch.clamp(omegas, min=1.0e-4)[None, :].expand_as(c_prev)
    nl = props.shape[0] // 4
    layers = tuple(props[k * nl:(k + 1) * nl].T for k in range(3)) + (
        (props[3 * nl:] if rho is None else rho).T,)
    top_l = torch.clamp(top.to(torch.int64), max=nl - 2)

    def sec(c):
        return _swd.secular_plain(omega / c, omega, *layers, top_l, iwave)

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
    prepass = newton_iters + int(slope_prev is None) if newton_iters else 0
    evals = torch.full(c_prev.shape, prepass + 1, dtype=torch.int32,
                       device=c_prev.device)
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
        evals += (~(found | dead)).to(torch.int32)
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
    evals += nbisect * found.to(torch.int32)
    warm_roots_walk_plain.evaluations = evals
    c, slope = _swd.secant_close(lo, hi, f_lo, f_hi)
    return c, found, torch.where(found, slope, torch.zeros_like(slope))


def warm_roots_walk(props, omegas, c_prev, cm, bx, top, ring_k, trips,
                    nbisect, newton_iters, newton_maxshift,
                    slope_prev=None, iwave=2, rho=None, group=False):
    """Warm root solve of every (chain, period) lane, ``iwave`` 1 Love
    or 2 Rayleigh.

    ``props`` (4 NL, C) walker planes [d; a; b; rho] and ``cm``/``bx``/
    ``top`` (C,) from the model kernel, ``rho`` an optional (NL, C)
    density plane read in place of plane 3; ``omegas`` (R,) angular
    frequencies; ``c_prev``/``slope_prev`` (C, R) cached roots and
    slopes; ``group`` marks a group target's lanes (for the launch
    counts only).  Returns (root, found, slope), each (C, R).  CPU
    tensors run the plain twin; CUDA tensors launch the kernel."""
    if props.device.type == 'cpu':
        return warm_roots_walk_plain(props, omegas, c_prev, cm, bx, top,
                                     ring_k, trips, nbisect,
                                     newton_iters, newton_maxshift,
                                     slope_prev, iwave, rho)
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
    if rho is not None:
        _ext.require(rho, 'rho', dev, f32, (nl, C))
    c = torch.empty((C, R), dtype=f32, device=dev)
    found = torch.empty((C, R), dtype=torch.bool, device=dev)
    slope = torch.empty((C, R), dtype=f32, device=dev)
    geo = geometry(C, R, nl, int(iwave))
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_walk(
            _ext.ptr(props), _ext.ptr(rho), _ext.ptr(omegas),
            _ext.ptr(c_prev),
            _ext.ptr(cm), _ext.ptr(bx), _ext.ptr(top),
            _ext.ptr(slope_prev), nl, C, R, 2 * ring_k * trips,
            nbisect, newton_iters, float(newton_maxshift),
            int(slope_prev is not None), int(iwave), geo.threads, geo.tile,
            geo.smem, _ext.ptr(c), _ext.ptr(found), _ext.ptr(slope),
            _ext.stream(dev))
    _ext.check(rc, 'walk')
    w = warm_roots_walk
    w.launches += 1
    w.love_launches += int(iwave == 1)
    w.group_launches += int(group)
    w.group_love_launches += int(group and iwave == 1)
    w.sph_love_launches += int(rho is not None and not group)
    return c, found, slope


warm_roots_walk.launches = 0          # every launch
warm_roots_walk.love_launches = 0     # launches with iwave = 1
warm_roots_walk.group_launches = 0    # group targets' launches
warm_roots_walk.group_love_launches = 0   # of those, Love's
# phase launches with a density plane (spherical Love phase)
warm_roots_walk.sph_love_launches = 0
warm_roots_walk_plain.evaluations = None
