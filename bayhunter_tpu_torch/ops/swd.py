"""Rayleigh- and Love-wave phase dispersion: secular functions (plain
twins and kernels K4/K5), cold root search and the warm-solve driver.

Mirrors ``bayhunter_tpu/ops/swd.py``:

  * ``gtsolh`` and the per-chain lower bound / maximum velocity
    (``:299-316``, ``:950-966``);
  * ``dltar4`` with ``_var_quantities`` / ``_dnka_apply``
    (``:82-250``): the Dunkin compound-matrix recursion from the
    halfspace up with per-layer max-abs renormalisation, and ``dltar1``
    (``:253-292``), the Love SH 2-vector recursion, with the layer math
    of ``pallas_secular.py`` (reciprocal renormalisation for Rayleigh,
    ``omega`` clamped to 1e-4); the kernels ``secular4`` (K4,
    ``csrc/secular.cu``, replacing ``pallas_secular._dltar4_kernel``)
    and ``secular1`` (K5, ``_dltar1_kernel``), which take candidate
    phase velocities and form the wavenumbers omega / c themselves, a
    block a tile of whole chains (:func:`geometry`; :func:`store_map`
    writes out their store map for a CPU test);
  * the cold counting search ``_find_brackets_b`` (``:600-643``) and
    ``_ksection_refine`` (``:518-587``; f32 phase solves: one pass of
    KR = 15 interior points, then the closing secant) — the per-lane
    semantics of the per-chain ``_find_brackets`` that cold init runs;
  * ``warm_solve``: the walker branch of ``_roots_batch_impl``
    (``:1011-1253``) on the model-kernel operands.

  * the spherical-earth flattening ``sphere_flatten`` /
    ``sphere_flatten_T`` (``:319-368``) that the cold path applies
    before its search (the model kernel K1 has its own form,
    ``prep.py``);
  * group velocity (``:993-1006``, ``:1234-1245``, ``:1328-1378``): two
    phase solves at the periods t / (1 + HGR) and t / (1 - HGR), 2P
    lanes in that order, differenced (:func:`group_velocity`); float32
    group solves keep three refinement passes (``:880-887``);
  * higher modes: the counting search brackets the ``mode``-th sign
    change (``:627``);
  * the public solver ``surfdisp`` / ``surfdisp_batch``
    (``:1389-1426``): one batched cold solve of (C, NL) models;
  * ``interp``, the float32 semantics of ``jnp.interp`` (end values
    held), for targets of more than 60 periods.

Love's cold bracket starts from the same cm as Rayleigh's, the Rayleigh
halfspace ``gtsolh`` of the slowest layer (reference ``:1286-1295``).
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import lanes as _lanes
from bayhunter_tpu_torch.ops import walk
from bayhunter_tpu_torch.ops.voronoi import running_sum

TWOPI = 2.0 * np.pi
DDC = 0.005          # phase-velocity grid step (surfdisp96.f:126)
HGR = 0.005          # group-velocity frequency increment (surfdisp96.f:128)
EARTH_R = 6370.0     # sphere(): ar (surfdisp96.f:517)
CM_FACTOR = 0.95 * 0.90

# cold counting search and refinement (ops/swd.py defaults)
KBLOCK = 64
NBLOCKS = 16
KREFINE = 15


def _var_quantities(pq, r, prop, dpth):
    """Scaled cos/sin eigenfunction quantities of one wave type given
    the propagation-regime mask (subroutine ``var``)."""
    r_zero = r == 0.0
    r_safe = torch.where(r_zero, torch.ones_like(r), r)
    sin_p = torch.sin(pq)
    w_prop = torch.where(r_zero, dpth, sin_p / r_safe)
    x_prop = -r * sin_p
    cos_prop = torch.cos(pq)
    fac = torch.where(pq < 16.0, torch.exp(-2.0 * pq),
                      torch.zeros_like(pq))
    cos_ev = 0.5 * (1.0 + fac)
    sin_ev = 0.5 * (1.0 - fac)
    w_ev = torch.where(r_zero, dpth, sin_ev / r_safe)
    x_ev = r * sin_ev
    cos_ = torch.where(prop, cos_prop, cos_ev)
    w_ = torch.where(prop, w_prop, w_ev)
    x_ = torch.where(prop, x_prop, x_ev)
    ex = torch.where(prop, torch.zeros_like(pq), pq)
    return cos_, w_, x_, ex


def _vertical(wvno, xk):
    return torch.sqrt((wvno + xk) * torch.abs(wvno - xk))


def _dnka_apply(e, wvno2, gam, gammk, rho, a0, cpcq, cpy, cpz, cqw,
                cqx, xy, xz, wy, wz):
    """e_new_j = sum_i e_i ca_ij with Dunkin's 5x5 compound matrix."""
    gamm1 = gam - 1.0
    twgm1 = gam + gamm1
    gmgmk = gam * gammk
    gmgm1 = gam * gamm1
    gm1sq = gamm1 * gamm1
    rho2 = rho * rho
    a0pq = a0 - cpcq
    ca11 = cpcq - 2.0 * gmgm1 * a0pq - gmgmk * xz - wvno2 * gm1sq * wy
    ca12 = (wvno2 * cpy - cqx) / rho
    ca13 = -(twgm1 * a0pq + gammk * xz + wvno2 * gamm1 * wy) / rho
    ca14 = (cpz - wvno2 * cqw) / rho
    ca15 = -(2.0 * wvno2 * a0pq + xz + wvno2 * wvno2 * wy) / rho2
    ca21 = (gmgmk * cpz - gm1sq * cqw) * rho
    ca22 = cpcq
    ca23 = gammk * cpz - gamm1 * cqw
    ca24 = -wz
    ca25 = ca14
    ca41 = (gm1sq * cpy - gmgmk * cqx) * rho
    ca42 = -xy
    ca43 = gamm1 * cpy - gammk * cqx
    ca44 = ca22
    ca45 = ca12
    ca51 = -(2.0 * gmgmk * gm1sq * a0pq + gmgmk * gmgmk * xz
             + gm1sq * gm1sq * wy) * rho2
    ca52 = ca41
    ca53 = -(gammk * gamm1 * twgm1 * a0pq + gam * gammk * gammk * xz
             + gamm1 * gm1sq * wy) * rho
    ca54 = ca21
    ca55 = ca11
    t = -2.0 * wvno2
    ca31 = t * ca53
    ca32 = t * ca43
    ca33 = a0 + 2.0 * (cpcq - ca11)
    ca34 = t * ca23
    ca35 = t * ca13
    e1, e2, e3, e4, e5 = e
    return (e1 * ca11 + e2 * ca21 + e3 * ca31 + e4 * ca41 + e5 * ca51,
            e1 * ca12 + e2 * ca22 + e3 * ca32 + e4 * ca42 + e5 * ca52,
            e1 * ca13 + e2 * ca23 + e3 * ca33 + e4 * ca43 + e5 * ca53,
            e1 * ca14 + e2 * ca24 + e3 * ca34 + e4 * ca44 + e5 * ca54,
            e1 * ca15 + e2 * ca25 + e3 * ca35 + e4 * ca45 + e5 * ca55)


def _halfspace(wvno, wvno2, omega, a_hs, b_hs, rho_hs):
    """Halfspace E vector of the Dunkin recursion (surfdisp96.f:798-808)."""
    ra = _vertical(wvno, omega / a_hs)
    rb = _vertical(wvno, omega / b_hs)
    t_hs = b_hs / omega
    gammk = 2.0 * t_hs * t_hs
    gam = gammk * wvno2
    gamm1 = gam - 1.0
    return (rho_hs * rho_hs * (gamm1 * gamm1 - gam * gammk * ra * rb),
            -rho_hs * ra,
            rho_hs * (gamm1 - gammk * ra * rb),
            rho_hs * rb,
            wvno2 - ra * rb)


def _dltar4_layer(e, wvno, wvno2, omega, d_l, a_l, b_l, rho_l):
    """One Dunkin layer update, renormalised by its max-abs entry
    (``pallas_secular._dltar4_layer_math``)."""
    xka = omega / a_l
    xkb = omega / b_l
    ra = _vertical(wvno, xka)
    rb = _vertical(wvno, xkb)
    t_l = b_l / omega
    gammk = 2.0 * t_l * t_l
    gam = gammk * wvno2
    cosp, w, x, pex = _var_quantities(ra * d_l, ra, wvno < xka, d_l)
    cosq, y, z, sex = _var_quantities(rb * d_l, rb, wvno < xkb, d_l)
    exa = pex + sex
    a0 = torch.where(exa < 60.0, torch.exp(-exa), torch.zeros_like(exa))
    n = _dnka_apply(e, wvno2, gam, gammk, rho_l, a0, cosp * cosq,
                    cosp * y, cosp * z, cosq * w, cosq * x, x * y, x * z,
                    w * y, w * z)
    a = [torch.abs(v) for v in n]
    nrm = torch.maximum(torch.maximum(a[0], a[1]),
                        torch.maximum(torch.maximum(a[2], a[3]), a[4]))
    nrm = torch.where(nrm < 1e-40, torch.ones_like(nrm), nrm)
    inv = 1.0 / nrm
    return tuple(v * inv for v in n)


def _dltar1_halfspace(wvno, omega, b_hs, rho_hs):
    """Halfspace start of the Love recursion: (rho rb, 1/beta^2)."""
    e2 = 1.0 / (b_hs * b_hs)
    return rho_hs * _vertical(wvno, omega / b_hs), e2.expand_as(wvno)


def _dltar1_layer(e, wvno, omega, d_l, b_l, rho_l):
    """One Haskell SH layer update, renormalised by its max-abs entry
    (``pallas_secular._dltar1_layer_math``: S terms only)."""
    b_safe = torch.where(b_l <= 0.0, torch.ones_like(b_l), b_l)
    xkb = omega / b_safe
    rb = _vertical(wvno, xkb)
    xmu = rho_l * b_safe * b_safe
    cosq, y, z, _ = _var_quantities(rb * d_l, rb, wvno < xkb, d_l)
    e10 = e[0] * cosq + e[1] * xmu * z
    e20 = e[0] * y / xmu + e[1] * cosq
    nrm = torch.maximum(torch.abs(e10), torch.abs(e20))
    nrm = torch.where(nrm < 1e-40, torch.ones_like(nrm), nrm)
    return e10 / nrm, e20 / nrm


def layer_top(d):
    """(C,) deepest slot 0..NL-2 of (C, NL) thicknesses with d > 0,
    -1 for a pure halfspace."""
    nl = d.shape[1]
    idx = torch.arange(nl - 1, device=d.device)
    return torch.amax(torch.where(d[:, :nl - 1] > 0.0, idx,
                                  torch.full_like(idx, -1)), dim=1)


def secular_plain(wvno, omega, d, a, b, rho, top, iwave):
    """Secular values at candidate wavenumbers — the plain twin of
    kernels K4/K5 and of K2's secular function.

    ``wvno``/``omega``: (C, ...) candidate grids; ``d, a, b, rho``:
    (C, NL) padded layer arrays with the halfspace last (``a`` unused
    for Love); ``top`` (C,) the deepest slot applied (slots above it
    are zero-thickness copies of the halfspace, identities up to a
    positive scale); ``iwave`` 1 Love, 2 Rayleigh.  A surface water
    layer (b[0] <= 0) is skipped in the recursion; Rayleigh closes it
    with the water clause.  Returns values of the candidates' shape
    whose sign is the reference's; the positive scale is arbitrary."""
    omega = torch.clamp(omega, min=1.0e-4)
    wvno, omega = torch.broadcast_tensors(wvno, omega)
    extra = (1,) * (wvno.ndim - 1)
    C, nl = d.shape

    def col(x, i):
        return x[:, i].reshape((C,) + extra)

    water = col(b, 0) <= 0.0
    top = top.reshape((C,) + extra)
    if iwave == 1:
        e = _dltar1_halfspace(wvno, omega, col(b, nl - 1), col(rho, nl - 1))
    else:
        wvno2 = wvno * wvno
        e = _halfspace(wvno, wvno2, omega, col(a, nl - 1), col(b, nl - 1),
                       col(rho, nl - 1))
    deepest = int(top.max()) if top.numel() else -1
    for l in range(deepest, -1, -1):
        if iwave == 1:
            new = _dltar1_layer(e, wvno, omega, col(d, l), col(b, l),
                                col(rho, l))
        else:
            new = _dltar4_layer(e, wvno, wvno2, omega, col(d, l), col(a, l),
                                col(b, l), col(rho, l))
        keep = top < l
        if l == 0:
            keep = keep | water
        e = tuple(torch.where(keep, eo, en) for eo, en in zip(e, new))
    if iwave == 1:
        return e[0]
    xka0 = omega / col(a, 0)
    ra0 = _vertical(wvno, xka0)
    cosp_w, w_w, _, _ = _var_quantities(ra0 * col(d, 0), ra0, wvno < xka0,
                                        col(d, 0))
    return torch.where(water, cosp_w * e[0] - col(rho, 0) * w_w * e[1],
                       e[0])


def dltar4(wvno, omega, d, a, b, rho):
    """Rayleigh secular values (Dunkin recursion; the plain twin of K4)
    of (C, NL) layer arrays at (C, ...) candidates."""
    return secular_plain(wvno, omega, d, a, b, rho, layer_top(d), 2)


def dltar1(wvno, omega, d, b, rho):
    """Love secular values (Haskell SH recursion; the plain twin of K5,
    port of ``bayhunter_tpu/ops/swd.py`` ``dltar1``) of (C, NL) layer
    arrays at (C, ...) candidates."""
    return secular_plain(wvno, omega, d, None, b, rho, layer_top(d), 1)


MAX_THREADS = 256   # a block's threads (csrc/secular.cu SECULAR_MAX_THREADS)


class Geometry(NamedTuple):
    """Launch geometry of K4/K5: ``threads`` per block, ``tile`` whole
    chains per block, ``blocks``, dynamic shared bytes ``smem``."""
    threads: int
    tile: int
    blocks: int
    smem: int


def chain_floats(nl, R, iwave):
    """Shared floats per chain of K4's (``iwave`` 2) or K5's (1) tile
    (csrc/secular.cu ``rayleigh_floats``, ``love_floats``): the layer
    rows d, a (Love: mu), b, rho, the R angular frequencies and the
    invariant terms of every period at every slot (Rayleigh three, Love
    one)."""
    return 4 * nl + R + (3 if iwave == 2 else 1) * R * nl


@functools.lru_cache(maxsize=64)
def geometry(C, R, K, nl, iwave, elem=4):
    """K4's or K5's launch geometry for C chains of R periods, K
    candidates per period and nl layer slots, ``elem`` the bytes of the
    scalar type (4 float32, 8 the float64 instances).  A chain's R * K
    candidates take W = ceil(R K / 32) warp-slots; a tile of
    ``8 / gcd(W, 8)`` chains (at most C) makes the tile's warp-slots a
    whole number of rounds of the block's 8 warps, halved while the
    tile's shared memory would not fit."""
    warps = MAX_THREADS // _lanes.WARP
    W = -(-R * K // _lanes.WARP)
    per_chain = elem * chain_floats(nl, R, iwave) + 4      # + its top
    if per_chain > _lanes.SMEM_MAX:
        raise ValueError('K%d: %d periods of %d layer slots need %d bytes '
                         'of shared memory a chain, above %d'
                         % (4 if iwave == 2 else 5, R, nl, per_chain,
                            _lanes.SMEM_MAX))
    tile = warps // math.gcd(W, warps)
    while tile * per_chain > _lanes.SMEM_MAX:
        tile //= 2
    tile = max(1, min(tile, C))
    threads = _lanes.WARP * min(warps, tile * W)
    return Geometry(threads, tile, -(-C // tile), tile * per_chain)


def store_map(geo, C, R, K):
    """(blocks, rounds, threads) int64: the output element ``(chain * R
    + period) * K + candidate`` that each thread of each block stores in
    each round, -1 where it idles — the kernels' map, warp ``w`` taking
    warp-slot ``w + round * warps``, which is chain ``slot // W`` and
    candidates ``32 (slot % W)`` to ``32 (slot % W) + 31`` of its R K."""
    T, tile, B = geo.threads, geo.tile, geo.blocks
    warps = T // _lanes.WARP
    E = R * K
    W = -(-E // _lanes.WARP)
    rounds = -(-tile * W // warps)
    slot = (np.arange(rounds)[:, None] * warps
            + np.arange(T)[None, :] // _lanes.WARP)
    e = slot % W * _lanes.WARP + np.arange(T) % _lanes.WARP
    chain = np.arange(B)[:, None, None] * tile + slot // W
    tc = np.minimum(tile, C - np.arange(B) * tile)
    idle = (e >= E)[None] | (slot[None] >= (tc * W)[:, None, None])
    return np.where(idle, -1, chain * E + e)


def _broadcast_shape(a, b):
    """The broadcast of shapes ``a`` and ``b`` (what
    ``torch.broadcast_shapes`` gives, at a fraction of its host time)."""
    n = max(len(a), len(b))
    out = []
    for x, y in zip((1,) * (n - len(a)) + tuple(a),
                    (1,) * (n - len(b)) + tuple(b)):
        if x != y and 1 not in (x, y):
            raise ValueError('shapes %s and %s do not broadcast'
                             % (tuple(a), tuple(b)))
        out.append(max(x, y))
    return tuple(out)


# the kernels' scalar types: C entry suffix and element bytes
KERNEL_DTYPES = {torch.float32: ('', 4), torch.float64: ('_f64', 8)}


def _launch_secular(name, c, omega, layers, iwave):
    """(C, R) or (C, R, K) values of K4 (``bh_secular4``) or K5
    (``bh_secular1``) on CUDA tensors at the wavenumbers omega / c;
    ``layers`` the (C, NL) arrays the kernel takes.  float32 inputs run
    the float instance, float64 inputs the double one (entry
    ``name + '_f64'``); every tensor must have the layers' dtype.
    Broadcast inputs go to the kernel with their strides, uncopied."""
    dev = layers[0].device
    dt = layers[0].dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError('layer array 0 has dtype %s, expected float32 or '
                        'float64' % dt)
    suffix, elem = KERNEL_DTYPES[dt]
    C, nl = layers[0].shape
    shape = _broadcast_shape(c.shape, omega.shape)
    if len(shape) not in (2, 3) or shape[0] != C:
        raise ValueError('candidates of shape %s for %d chains: expected '
                         '(C, R) or (C, R, K)' % (shape, C))
    R, K = shape[1], shape[2] if len(shape) == 3 else 1
    cx, ox = c.expand(shape), omega.expand(shape)
    _ext.require(cx, 'c', dev, dt, shape, contiguous=False)
    _ext.require(ox, 'omega', dev, dt, shape, contiguous=False)
    for i, x in enumerate(layers):
        _ext.require(x, 'layer array %d' % i, dev, dt, (C, nl))
    sc = cx.stride() + (0,) * (3 - len(shape))
    so = ox.stride() + (0,) * (3 - len(shape))
    if so[2] != 0 and K > 1:
        raise ValueError('omega varies along the candidate axis')
    if C * R * K >= 2 ** 31:
        raise ValueError('%d candidates: above the kernels\' int range'
                         % (C * R * K))
    out = torch.empty(shape, dtype=dt, device=dev)
    geo = geometry(C, R, K, nl, iwave, elem)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = getattr(lib, name + suffix)(
            _ext.ptr(c), *sc, _ext.ptr(omega), *so[:2],
            *(_ext.ptr(x) for x in layers), nl, C, R, K, geo.threads,
            geo.tile, geo.smem, _ext.ptr(out), _ext.stream(dev))
    _ext.check(rc, name + suffix)
    return out


def secular4(c, omega, d, a, b, rho):
    """K4: Rayleigh secular values of (C, NL) layer arrays at the
    wavenumbers omega / c of candidate phase velocities ``c`` and
    angular frequencies ``omega``, (C, R) or (C, R, K) once broadcast
    (omega constant along K).  CPU tensors run the plain twin
    :func:`dltar4`; CUDA tensors launch the kernel, its float32 or its
    float64 instance by the layers' dtype (``f64_launches`` counts the
    latter, ``launches`` the former)."""
    if c.device.type == 'cpu':
        return dltar4(omega / c, omega, d, a, b, rho)
    out = _launch_secular('bh_secular4', c, omega, (d, a, b, rho), 2)
    _count(secular4, d)
    return out


def secular1(c, omega, d, b, rho):
    """K5: Love secular values of (C, NL) layer arrays at the
    wavenumbers omega / c (as :func:`secular4`).  CPU tensors run the
    plain twin :func:`dltar1`; CUDA tensors launch the kernel."""
    if c.device.type == 'cpu':
        return dltar1(omega / c, omega, d, b, rho)
    out = _launch_secular('bh_secular1', c, omega, (d, b, rho), 1)
    _count(secular1, d)
    return out


def _count(wrapper, x):
    """One launch of ``wrapper``'s kernel at ``x``'s dtype."""
    if x.dtype == torch.float64:
        wrapper.f64_launches += 1
    else:
        wrapper.launches += 1


secular4.launches = secular4.f64_launches = 0
secular1.launches = secular1.f64_launches = 0


def secular_at(c, omega, d, a, b, rho, iwave):
    """Secular values of wave type ``iwave`` (1 Love: K5, 2 Rayleigh:
    K4) of (C, NL) layer arrays at the wavenumbers omega / c of
    candidate phase velocities ``c``: the cold search's callback."""
    if iwave == 1:
        return secular1(c, omega, d, b, rho)
    return secular4(c, omega, d, a, b, rho)


def secular_values(wvno, omega, d, a, b, rho, iwave):
    """The plain twins of K4/K5 by wave type (1 Love :func:`dltar1`, 2
    Rayleigh :func:`dltar4`) at given wavenumbers, on any device; the
    kernels take phase velocities (:func:`secular_at`)."""
    if iwave == 1:
        return dltar1(wvno, omega, d, b, rho)
    return dltar4(wvno, omega, d, a, b, rho)


def resident_warps(geo, iwave):
    """Warps of K4 (``iwave`` 2) or K5 (1) that one SM holds at once at
    the geometry ``geo``: the CUDA occupancy calculator's blocks per SM
    (registers, shared memory, block limits) times the block's warps."""
    blocks = ctypes.c_int(0)
    _ext.check(_ext.load().bh_secular_occupancy(
        iwave, geo.threads, geo.smem, ctypes.byref(blocks)),
        'secular occupancy')
    return blocks.value * geo.threads // _lanes.WARP


def gtsolh(a, b):
    """Halfspace Rayleigh-velocity starting solution: 5 Newton steps
    on the halfspace period equation (surfdisp96.f:367-388)."""
    c = 0.95 * b
    for _ in range(5):
        gamma = b / a
        kappa = c / b
        k2 = kappa * kappa
        gk = gamma * kappa
        gk2 = gk * gk
        fac1 = torch.sqrt(torch.clamp(1.0 - gk2, min=1e-30))
        fac2 = torch.sqrt(torch.clamp(1.0 - k2, min=1e-30))
        tk = 2.0 - k2
        fr = tk * tk - 4.0 * fac1 * fac2
        frp = (-4.0 * tk * kappa
               + 4.0 * fac2 * gamma * gamma * kappa / fac1
               + 4.0 * fac1 * kappa / fac2)
        frp = frp / b
        c = c - fr / frp
    return c


def lower_bound(a, b, dim):
    """(cm, betmx) along layer axis ``dim``: cm = 0.95 * 0.90 *
    gtsolh at the slowest layer (its velocity if fluid), betmx the
    largest S velocity (surfdisp96.f:140-217)."""
    solid = b > 0.01
    cand = torch.where(solid, b, a)
    jmn = torch.argmin(cand, dim=dim, keepdim=True)
    betmn = torch.gather(cand, dim, jmn).squeeze(dim)
    a_mn = torch.gather(a, dim, jmn).squeeze(dim)
    b_mn = torch.gather(b, dim, jmn).squeeze(dim)
    jsol = torch.gather(solid, dim, jmn).squeeze(dim)
    cc1 = torch.where(jsol, gtsolh(a_mn, b_mn), betmn)
    return CM_FACTOR * cc1, torch.amax(b, dim=dim)


def sphere_flatten_T(d, a, b, rho, iwave):
    """Spherical-earth to flat-earth transform of (NL, C) layer planes
    (surfdisp96.f:486-553; ``bayhunter_tpu/ops/swd.py``
    ``sphere_flatten_T``): layer-midpoint velocity mapping, Biswas
    density mapping with exponent -5 (Love, ``iwave`` 1) or -2.275
    (Rayleigh) as ``tmp ** ex``.  The halfspace slot takes a fictitious
    1 km thickness for its midpoint and keeps zero thickness;
    zero-thickness padded slots keep zero thickness.  Depths accumulate
    slot by slot (the bottoms), the tops are bottom - thickness, as the
    JAX cold path computes them.  The model kernel K1 has its own form
    (``prep.sphere_operands_T``)."""
    d_eff = torch.cat([d[:-1], torch.ones_like(d[-1:])], dim=0)
    zb = running_sum(d_eff)
    zt = zb - d_eff
    r = torch.full_like(d, EARTH_R)      # tensor / tensor: IEEE division
    r0 = r - zt
    r1 = r - zb
    z0 = EARTH_R * torch.log(r / r0)
    z1 = EARTH_R * torch.log(r / r1)
    d_f = z1 - z0
    tmp = (r + r) / (r0 + r1)
    ex = -5.0 if iwave == 1 else -2.275
    rho_f = rho * torch.pow(tmp, ex)
    d_f = torch.cat([d_f[:-1], torch.zeros_like(d_f[-1:])], dim=0)
    return d_f, a * tmp, b * tmp, rho_f


def sphere_flatten(d, a, b, rho, iwave):
    """:func:`sphere_flatten_T` of row-major (C, NL) layer arrays."""
    return tuple(x.T.contiguous() for x in sphere_flatten_T(
        d.T, a.T, b.T, rho.T, iwave))


def lane_periods(periods, igr, device, dtype=torch.float32):
    """(t (P,), lanes (L,)): the periods as a tensor, and the periods of
    the solve's lanes — t itself for phase velocity, for group velocity
    (``igr`` > 0) the 2P periods t / (1 + HGR), then t / (1 - HGR)
    (surfdisp96.f:232-239)."""
    t = torch.as_tensor(np.asarray(periods), dtype=dtype, device=device)
    if not igr:
        return t, t
    return t, torch.cat([t / torch.full_like(t, 1.0 + HGR),
                         t / torch.full_like(t, 1.0 - HGR)])


def lane_frequencies(periods, igr, device, dtype=torch.float32):
    """2 pi / T of the solve's lanes (:func:`lane_periods`)."""
    return angular_frequencies(lane_periods(periods, igr, device, dtype)[1],
                               device, dtype)


def group_velocity(c, found, t):
    """(velocity (C, P), ok (C, P)) of a group solve's roots ``c`` (C, 2P)
    at the lane periods of :func:`lane_periods`: the differenced
    (1/t1a - 1/t1b) / (1/(t1a ca) - 1/(t1b cb)), ok where both roots
    were found."""
    P = t.shape[0]
    t1a = t / torch.full_like(t, 1.0 + HGR)
    t1b = t / torch.full_like(t, 1.0 - HGR)
    ca, cb = c[..., :P], c[..., P:]
    out = ((torch.reciprocal(t1a) - torch.reciprocal(t1b))
           / (torch.reciprocal(t1a * ca) - torch.reciprocal(t1b * cb)))
    return out, found[..., :P] & found[..., P:]


def velocities(c, found, t, igr):
    """(cg, err) of a solve's roots: phase velocity, or the
    :func:`group_velocity` of a group solve; zero-filled from the first
    failed period on (surfdisp96.f:313-354), err when any period
    failed."""
    if igr:
        c, found = group_velocity(c, found, t)
    return _finish(c, found)


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` of each row of ``fp`` (C, m) at the
    points ``x`` (n,), ``xp`` (m,) increasing: linear between the
    bracketing points of ``searchsorted(xp, x, side='right')`` clipped
    to 1..m-1, the end values outside [xp[0], xp[-1]] (the reference's
    >60-period interpolation, src/surf96_modsw.py:106-122)."""
    m = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, m - 1)
    f0 = fp[..., i - 1]
    df = fp[..., i] - f0
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(
        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def _find_brackets_b(omega, cm, betmx, secular, mode, K, nblocks):
    """Counting search: walk blocks of K grid points (step DDC) up
    from cm, counting sign changes; the ``mode``-th brackets that mode
    (1 the fundamental).  omega
    (C, R), cm/betmx (C, 1); ``secular(c, omega)`` gives the values at
    the wavenumbers omega / c.  Returns (lo, found), each (C, R)."""
    dtype, dev = omega.dtype, omega.device
    dc = torch.tensor(DDC, dtype=dtype, device=dev)
    koff = torch.arange(1, K + 1, dtype=dtype, device=dev) * dc
    sign0 = secular(cm, omega) > 0
    P = omega.shape
    prev_sign = sign0
    cnt = torch.zeros(P, dtype=torch.int64, device=dev)
    found = torch.zeros(P, dtype=torch.bool, device=dev)
    lo = cm.expand(P).clone()
    limit = betmx + dc
    for j in range(nblocks):
        base = cm + torch.tensor(j * K, dtype=dtype, device=dev) * dc
        if bool((found | (base > limit)).all()):
            break
        c = base[..., None] + koff                        # (C, 1, K)
        valid = c <= limit[..., None]
        sg = secular(c, omega[..., None]) > 0
        allsg = torch.cat([prev_sign[..., None], sg], dim=-1)
        flips = (allsg[..., 1:] != allsg[..., :-1]) & valid
        cum = cnt[..., None] + torch.cumsum(flips.to(torch.int64), -1)
        hit = (cum == mode) & flips
        has_hit = hit.any(dim=-1)
        idx = torch.argmax(hit.to(torch.int8), dim=-1)
        lo_new = base + idx.to(dtype) * dc
        newly = has_hit & ~found
        lo = torch.where(newly, lo_new, lo)
        found = found | newly
        cnt = cum[..., -1]
        prev_sign = sg[..., -1]
    return lo, found


# points a ring block evaluates per lane at most (both sides): the trips
# of a block double from 1 up to this
RING_BLOCK_POINTS = 256


def ring_brackets(omega, c_prev, cm, betmx, secular, K, max_trips):
    """Bracket the sign change nearest to ``c_prev`` by expanding rings
    of K grid points (step DDC) on each side: the pure expanding ring of
    ``bayhunter_tpu/ops/swd.py`` ``_ring_brackets`` (``:427-516``), with
    its trip semantics.  Trip t evaluates c_prev + t K DDC + k DDC and
    c_prev - t K DDC - k DDC (k = 1..K); c_prev's sign seeds both sides;
    a flip counts only at a point in range (right: <= betmx + DDC, left:
    >= cm); the first trip with a flip on either side wins, within it
    the nearer side, ties going up (right flip j -> [pt_j - DDC, pt_j],
    left -> [pt_j, pt_j + DDC]); a lane is dead once the first points of
    both sides of a trip leave the range; at most ``max_trips`` trips.

    ``omega`` and ``c_prev`` (C, R), ``cm`` and ``betmx`` (C, 1);
    ``secular(c, omega, rows)`` gives the values at the wavenumbers
    omega / c of the chains ``rows`` (an index tensor, None for all).
    Trips run in blocks, one ``secular`` call each (the first block trip
    0 alone, then 2, 4, ... trips up to ``RING_BLOCK_POINTS`` points a
    lane), on the chains with a lane neither found nor dead, with one
    host sync a block; the earliest trip of a block with a flip gives
    the bracket that trip-by-trip order gives.  Returns (lo, found),
    each (C, R); an unfound lane's lo is cm."""
    dtype, dev = omega.dtype, omega.device
    C, R = omega.shape
    dc = torch.tensor(DDC, dtype=dtype, device=dev)
    ksteps = torch.arange(1, K + 1, dtype=dtype, device=dev) * dc
    limit = betmx + dc
    lo = cm.expand(C, R).clone()
    found = torch.zeros((C, R), dtype=torch.bool, device=dev)
    rows = None
    sR = sL = None
    t0, nb = 0, 1
    max_block = max(1, RING_BLOCK_POINTS // (2 * K))
    while t0 < max_trips:
        nb = min(nb, max_trips - t0)

        def sub(x):
            return x if rows is None else x[rows]

        cp, om, cm_r, lim = sub(c_prev), sub(omega), sub(cm), sub(limit)
        n = cp.shape[0]
        base = (torch.arange(t0, t0 + nb, device=dev) * K).to(dtype) * dc
        ptsR = (cp[..., None, None] + base[:, None]) + ksteps  # (n,R,nb,K)
        ptsL = (cp[..., None, None] - base[:, None]) - ksteps
        pts = [ptsR.reshape(n, R, nb * K), ptsL.reshape(n, R, nb * K)]
        if t0 == 0:
            pts.insert(0, cp[..., None])
        sg = secular(torch.cat(pts, dim=-1), om[..., None], rows) > 0
        if t0 == 0:
            sR = sL = sg[..., 0]
            sg = sg[..., 1:]
        sgR, sgL = sg[..., :nb * K], sg[..., nb * K:]
        validR = ptsR <= lim[..., None, None]
        validL = ptsL >= cm_r[..., None, None]
        allR = torch.cat([sR[..., None], sgR], dim=-1)
        allL = torch.cat([sL[..., None], sgL], dim=-1)
        flipR = (allR[..., 1:] != allR[..., :-1]).reshape(n, R, nb, K) \
            & validR
        flipL = (allL[..., 1:] != allL[..., :-1]).reshape(n, R, nb, K) \
            & validL
        hasR, hasL = flipR.any(dim=-1), flipL.any(dim=-1)     # (n, R, nb)
        jR = torch.argmax(flipR.to(torch.int8), dim=-1, keepdim=True)
        jL = torch.argmax(flipL.to(torch.int8), dim=-1, keepdim=True)
        loR = torch.gather(ptsR, -1, jR)[..., 0] - dc
        loL = torch.gather(ptsL, -1, jL)[..., 0]
        useL = hasL & (~hasR | (jL[..., 0] < jR[..., 0]))
        lo_t = torch.where(useL, loL, loR)
        hit_t = hasR | hasL
        first = torch.argmax(hit_t.to(torch.int8), dim=-1, keepdim=True)
        newly = hit_t.any(dim=-1) & ~sub(found)
        lo_n = torch.where(newly, torch.gather(lo_t, -1, first)[..., 0],
                           sub(lo))
        found_n = sub(found) | newly
        dead = (~validR[..., 0] & ~validL[..., 0]).any(dim=-1)
        if rows is None:
            lo, found = lo_n, found_n
        else:
            lo = lo.index_put((rows,), lo_n)
            found = found.index_put((rows,), found_n)
        sR, sL = sgR[..., -1], sgL[..., -1]
        t0 += nb
        nb = min(2 * nb, max_block)
        keep = torch.nonzero(~(found_n | dead).all(dim=-1))[:, 0]
        if keep.numel() == 0:                   # the block's one sync
            break
        rows = keep if rows is None else rows[keep]
        sR, sL = sR[keep], sL[keep]
    ring_brackets.calls += 1
    ring_brackets.trips += t0
    return lo, found


# calls, and trips run (the blocks' trips summed over calls): host
# counters that a caller reads to see how far the rings expanded
ring_brackets.calls = ring_brackets.trips = 0


def _ksection_refine(omega, lo, secular, KR, niter):
    """Narrow the (lo, lo + DDC) bracket by (KR+1)^niter, then one
    secant step on the final bracket's values, with the smaller-|f|
    endpoint where the secant leaves the bracket.  Returns
    (root, slope), the slope being the final bracket's secant."""
    dc = torch.tensor(DDC, dtype=omega.dtype, device=omega.device)
    hi = lo + dc
    fracs = (torch.arange(0, KR + 2, dtype=omega.dtype,
                          device=omega.device)
             / (KR + 1))
    f_lo = f_hi = torch.zeros_like(lo)
    for _ in range(niter):
        pts = lo[..., None] + (hi - lo)[..., None] * fracs
        vals = secular(pts, omega[..., None])
        s_lo = vals[..., 0] > 0
        diff = (vals[..., 1:] > 0) != s_lo[..., None]
        idx = torch.argmax(diff.to(torch.int8), dim=-1)
        idx = torch.where(diff.any(dim=-1), idx, torch.full_like(idx, KR))
        ix = idx[..., None]
        hi = torch.gather(pts[..., 1:], -1, ix)[..., 0]
        f_hi = torch.gather(vals[..., 1:], -1, ix)[..., 0]
        lo = torch.gather(pts[..., :-1], -1, ix)[..., 0]
        f_lo = torch.gather(vals[..., :-1], -1, ix)[..., 0]
    return secant_close(lo, hi, f_lo, f_hi)


def secant_close(lo, hi, f_lo, f_hi):
    """Closing secant on a bracket's values (smaller-|f| endpoint when
    it leaves the bracket) and the bracket's slope."""
    one = torch.ones_like(lo)
    denom = f_hi - f_lo
    denom = torch.where(denom == 0.0, one, denom)
    c = lo - f_lo * (hi - lo) / denom
    edge = torch.where(torch.abs(f_lo) <= torch.abs(f_hi), lo, hi)
    good = (c > lo) & (c < hi) & torch.isfinite(c)
    width = hi - lo
    slope = (f_hi - f_lo) / torch.where(width == 0.0, one, width)
    return torch.where(good, c, edge), slope


def _finish(c, found):
    """(cg, err): zero-fill from the first failed period on
    (surfdisp96.f:313-354); err when any period failed."""
    failed_cum = torch.cumsum((~found).to(torch.int32), dim=-1) > 0
    cg = torch.where(failed_cum, torch.zeros_like(c), c)
    return cg, (~found).any(dim=-1)


def surfdisp_roots_cold(h, vp, vs, rho, periods, iwave=2, mode=1, igr=0,
                        iflsph=0):
    """Cold solve (``iwave`` 1 Love, 2 Rayleigh; ``mode`` 1 the
    fundamental; ``igr`` > 0 group velocity; ``iflsph`` 1 a spherical
    earth) of a row-major (C, NL) batch: flattening, counting search
    from cm, then refinement (one pass for float32 phase solves, three
    for group solves and float64, as the reference), every secular
    evaluation through K4 or K5.

    Returns (cg (C, P), err (C,), roots (C, L), slopes (C, L)), L = P
    lanes for phase velocity and 2P for group velocity
    (:func:`lane_periods`); the slope of an unfound lane is the 0.0
    no-cache sentinel."""
    dtype = h.dtype
    niter = 1 if dtype == torch.float32 and not igr else 3
    if iflsph == 1:
        h, vp, vs, rho = sphere_flatten(h, vp, vs, rho, iwave)
    cm, betmx = lower_bound(vp, vs, dim=-1)
    cm, betmx = cm[:, None], betmx[:, None]
    t, lanes = lane_periods(periods, igr, h.device, dtype)
    omegas = angular_frequencies(lanes, h.device, dtype).expand(
        h.shape[0], -1)

    def secular(c, omega):
        return secular_at(c, omega, h, vp, vs, rho, iwave)

    lo, found = _find_brackets_b(omegas, cm, betmx, secular, mode, KBLOCK,
                                 NBLOCKS)
    c, slope = _ksection_refine(omegas, lo, secular, KREFINE, niter)
    slope = torch.where(found, slope, torch.zeros_like(slope))
    cg, err = velocities(c, found, t, igr)
    return cg, err, c, slope


def surfdisp_roots_warm(h, vp, vs, rho, periods, c_prev, ring, iwave=2,
                        mode=1, igr=0, iflsph=0):
    """Warm solve of a row-major (C, NL) batch from the previous roots
    ``c_prev`` (C, L): the JAX package's per-chain ``surfdisp_roots``
    with ``c_prev`` (``bayhunter_tpu/ops/swd.py:1329-1342``) — the
    flattening, the roots clipped to [cm, betmx], the pure expanding
    ring of half-width ``ring`` (:func:`ring_brackets`, at most
    (KBLOCK NBLOCKS) // ring trips), then the refinement
    (:func:`_ksection_refine`, one pass for float32 phase solves, three
    for group solves and float64), every secular evaluation through K4
    or K5 at the layers' dtype.  ``mode`` is taken for the cold solve's
    signature: the ring brackets the sign change nearest the previous
    root.  Returns (cg, err, roots, slopes) as
    :func:`surfdisp_roots_cold`."""
    dtype = h.dtype
    niter = 1 if dtype == torch.float32 and not igr else 3
    if iflsph == 1:
        h, vp, vs, rho = sphere_flatten(h, vp, vs, rho, iwave)
    cm, betmx = lower_bound(vp, vs, dim=-1)
    cm, betmx = cm[:, None], betmx[:, None]
    t, lanes = lane_periods(periods, igr, h.device, dtype)
    omegas = angular_frequencies(lanes, h.device, dtype).expand(
        h.shape[0], -1)
    cp = torch.minimum(torch.maximum(c_prev.to(dtype), cm), betmx)
    layers = (h, vp, vs, rho)

    def secular(c, omega, rows=None):
        lay = layers if rows is None else tuple(x[rows] for x in layers)
        return secular_at(c, omega, *lay, iwave)

    trips = max(1, (KBLOCK * NBLOCKS) // ring)
    lo, found = ring_brackets(omegas, cp, cm, betmx, secular, ring, trips)
    c, slope = _ksection_refine(omegas, lo, secular, KREFINE, niter)
    slope = torch.where(found, slope, torch.zeros_like(slope))
    cg, err = velocities(c, found, t, igr)
    return cg, err, c, slope


def _model_tensors(arrays, device):
    """(C, NL) layer arrays as tensors: tensors keep their dtype and go
    to ``device`` when given; arrays become float32 on ``device``, by
    default CUDA."""
    if device is None:
        device = (arrays[0].device if torch.is_tensor(arrays[0])
                  else torch.device('cuda'))
    out = []
    for x in arrays:
        if torch.is_tensor(x):
            out.append(x.to(device))
        else:
            out.append(torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                       device=device))
    return out


def surfdisp_batch(h, vp, vs, rho, periods, iwave=2, mode=1, igr=0,
                   iflsph=0, device=None):
    """Dispersion curves of C layered models (``bayhunter_tpu/ops/
    swd.py:1389-1426``, batched as one cold solve).

      h, vp, vs, rho : (C, NL) layer arrays, halfspace last
      periods        : (P,) periods in s (increasing)
      iwave          : 1 Love, 2 Rayleigh
      mode           : 1 fundamental, 2 first higher, ...
      igr            : 0 phase velocity, > 0 group velocity
      iflsph         : 0 flat earth, 1 spherical (flattening applied)

    Returns ``(cg, err)``: (C, P) phase or group velocities, zeros from
    the first failed period on, and (C,) True where a period failed.
    Arrays go to ``device`` (default: CUDA; tensors stay on their own
    device unless ``device`` is given); CPU tensors run the plain twins
    of K4 and K5."""
    h, vp, vs, rho = _model_tensors((h, vp, vs, rho), device)
    cg, err, _, _ = surfdisp_roots_cold(h, vp, vs, rho, periods, iwave,
                                        mode, igr, iflsph)
    return cg, err


def surfdisp(h, vp, vs, rho, periods, iwave=2, mode=1, igr=0, iflsph=0,
             device=None):
    """Dispersion curve of one model of (NL,) layer arrays (halfspace
    last): ``(cg (P,), err)`` of :func:`surfdisp_batch` with C = 1."""
    def one(x):
        return x[None] if torch.is_tensor(x) else np.asarray(x)[None]
    cg, err = surfdisp_batch(one(h), one(vp), one(vs), one(rho), periods,
                             iwave, mode, igr, iflsph, device)
    return cg[0], err[0]


# warm-solve settings per move class (ops/swd.py:1068-1195 with the
# sampler's ring widths, chain.py:432-496): Newton iterations, ring
# width, walk bisections, and whether the cached slope seeds the first
# Newton pass
WARM_VS = dict(newton_iters=1, ring=2, nbisect=0, cached_slope=True)
WARM_Z = dict(newton_iters=0, ring=8, nbisect=1, cached_slope=False)
WARM_DIM = dict(newton_iters=2, ring=1, nbisect=0, cached_slope=False)
# vp/vs moves: the JAX sampler recentres them by Newton
# (_pert_newton_for(MOVE_VPVS): BAYHUNTER_VPVS_PREPASS, unset, reads
# 'newton'), so _ring_width_for(MOVE_VPVS, newton=True) gives ring 2,
# the walker one Newton pass (ops/swd.py:1068-1073, not a dimension
# move) and no bisection (recentred, :1189-1194), seeded by the cached
# slope (evaluator.py:685-688, _SLOPE_CACHE on): the vs moves' settings
WARM_VPVS = dict(WARM_VS)
WARM_CAP = 2                                   # evaluator.py:111
NEWTON_MAXSHIFT = 3.0 * 64 * DDC
# bisections of a group solve's warm walk: 4 nrefine, nrefine 3 for
# any float32 group solve (ops/swd.py:880-887, :1182-1195)
GROUP_NBISECT = 12


def angular_frequencies(periods, device, dtype=torch.float32):
    """2 pi / T as a tensor on ``device`` (``periods`` an array or a
    tensor)."""
    t = torch.as_tensor(periods, dtype=dtype, device=device)
    return torch.full_like(t, TWOPI) / t


def warm_solve(props, cm, bx, top, omegas, c_prev, settings,
               slope_prev=None, iwave=2, rho=None, group=False):
    """Warm root solve (``iwave`` 1 Love, 2 Rayleigh) of every lane on
    the model-kernel operands (the walker branch of
    ``_roots_batch_impl``).

    ``props`` (4 NL, C) walker planes [d; a; b; rho] and ``rho`` an
    optional (NL, C) density plane read in place of plane 3 (a
    spherical Love target's); ``cm``/``bx``/``top`` (C,); ``omegas``
    (L,) angular frequencies of the lanes; ``c_prev``/``slope_prev``
    (C, L) from the forward cache; ``settings`` one of WARM_VS /
    WARM_Z / WARM_DIM / WARM_VPVS; ``group``: the lanes of a group
    target, which take ``GROUP_NBISECT`` bisections in every move class
    (``ops/swd.py:1182-1195``).  The walk makes at most 2 ring trips
    (the warm cap).  Returns (roots, found, slopes), each (C, L)."""
    sl = slope_prev if settings['cached_slope'] else None
    return walk.warm_roots_walk(
        props, omegas, c_prev, cm, bx, top, ring_k=settings['ring'],
        trips=WARM_CAP,
        nbisect=GROUP_NBISECT if group else settings['nbisect'],
        newton_iters=settings['newton_iters'],
        newton_maxshift=NEWTON_MAXSHIFT, slope_prev=sl, iwave=iwave,
        rho=rho, group=group)
