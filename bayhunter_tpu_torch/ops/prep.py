"""K1: the model kernel, and K6: its RF operands alone — CUDA kernels
and plain twins.

Mirrors ``bayhunter_tpu/ops/pallas_prep.py`` (``_model_kernel``,
``model_operands_t``) for dispersion targets on a flat or a spherical
earth, each given as an (iwave, flsph) spec, and any number (up to
``_ext.RF_MAX``) of receiver-function targets with flattening, each
given as a (slowness, wave type) spec, as the JAX kernel's ``specs``
tuple gives them.  From depth-sorted (NL, C) nucleus planes it
computes, per chain:

  * the prior validity (layer count, thickness, vs bounds, interface
    depths, optional low/high-velocity-zone limits);
  * one set of walker planes [d; a; b; rho] (4 NL, C), lower bound cm,
    betmx and deepest layer ``top`` (-1 for a pure halfspace) per
    flattening present — flat, and spherical (``_swd_rows`` iflsph 1,
    :func:`sphere_operands_T`: R = 6370 km, Rayleigh density exponent
    -2.275) — and one Love density plane (exponent -5) that the
    spherical Love targets share;
  * per RF target, the rfmini-flattened RF operands: the ((NL-1)*32, C)
    interface table (row l*32 + m*8 + e*2 + c for matrix m in (rd, td,
    ru, tu), entry e in (11, 12, 21, 22), re/im c) and the per-chain
    pack (rows named by ``rf.pack_offsets``; its t0 is the direct P or
    S arrival time).

K1 also returns the layered model's planes for a custom target's
forward (``layers``).

K6 (``rf_operands``) computes the last item from (NL, C) layer planes
for the cold evaluation and the batched RF forward, with the
flattening or on the raw layers (``flattening``), as
``pallas_prep.rf_operands_t`` does; both kernels share its device code
(``csrc/prep.cu`` ``rf_item``).

Both kernels give a block a tile of whole chains (:func:`geometry`)
and write all their planes into one output buffer, which the wrappers
return as row views.  :func:`item_stores` writes out the kernels'
map from items to stores, so that a CPU test can check that every
output element is stored once.
"""

import functools
import typing

import numpy as np
import torch

from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import lanes as _lanes
from bayhunter_tpu_torch.ops import rf as _rf
from bayhunter_tpu_torch.ops import swd as _swd
from bayhunter_tpu_torch.ops import voronoi as _vor


class ModelPriors(typing.NamedTuple):
    """Static prior bounds the model kernel checks, and the optional
    mantle prior (vs threshold, mantle vp/vs) it applies."""
    layermin: int
    layermax: int
    vsmin: float
    vsmax: float
    zmin: float
    zmax: float
    thickmin: float
    lvz: typing.Optional[float]
    hvz: typing.Optional[float]
    mantle: typing.Optional[tuple] = None

    @property
    def as_dict(self):
        return {'layers': (self.layermin, self.layermax),
                'vs': (self.vsmin, self.vsmax),
                'z': (self.zmin, self.zmax)}


MAX_THREADS = 256      # a block's threads (csrc/prep.cu PREP_MAX_THREADS)
TILES = (32, 16)       # chains per block, the widest first


class Geometry(typing.NamedTuple):
    """Launch geometry of K1 or K6: ``threads`` per block, ``tile``
    whole chains per block, ``blocks``, dynamic shared bytes ``smem``."""
    threads: int
    tile: int
    blocks: int
    smem: int


def tile_floats(nl, model=True, sph=False):
    """Shared floats per chain of K1's (``model``) or K6's tile: K1's
    raw vs and z, its layered (then flattened) h, vp, vs, rho, the
    running depths (nl + 1) and vpvs and n, and with a spherical set
    (``sph``) its flattened d, a, b; K6's layer planes and running
    depths."""
    if not model:
        return 5 * nl + 1
    return 10 * nl + 3 if sph else 7 * nl + 3


def rf_items(nl, tc, off):
    """Items of one RF target in a tile of ``tc`` chains: an item per
    interface, one per chain, one per stored pack row that is not the
    chain item's (the h, vp, vs planes, the slowness, the padding)."""
    return (nl - 1) * tc + tc + (3 * nl + 1 + off['rows'] - off['depth']
                                 - 1) * tc


@functools.lru_cache(maxsize=64)
def geometry(C, nl, n_rf, model=True, sph=False, elem=4):
    """K1's (``model``; ``sph`` with a spherical set) or K6's launch
    geometry for C chains of nl layer slots and ``n_rf`` RF targets
    (K6: 1), ``elem`` the bytes of the scalar type (8 for K6's float64
    instance): tiles of 32 chains where that gives at least two blocks
    per SM, else of 16 (a 2,048-chain cold chunk: 128 blocks), and
    enough threads for a tile's items up to ``MAX_THREADS``."""
    floats = tile_floats(nl, model, sph)
    tile = next((t for t in TILES if -(-C // t) >= 2 * _lanes.SMS
                 and elem * floats * t <= _lanes.SMEM_MAX), TILES[-1])
    smem = elem * floats * tile
    if smem > _lanes.SMEM_MAX:
        raise ValueError('%s: %d layer slots need %d bytes of shared '
                         'memory, above %d' % ('K1' if model else 'K6', nl,
                                               smem, _lanes.SMEM_MAX))
    work = max(nl * tile, n_rf * rf_items(nl, tile, _rf.pack_offsets(nl)))
    threads = min(MAX_THREADS, -(-work // _lanes.WARP) * _lanes.WARP)
    return Geometry(threads, tile, -(-C // tile), smem)


FLAT_SETS = (1, 0, 0)       # the flat set only, as without SWD specs


def swd_sets(swd_specs):
    """(flat, sph, love) flags of K1's dispersion sets for ``swd_specs``
    ((iwave, flsph) per SWD target; None: the flat set only).  The flat
    kernel writes the flat set whatever its flag."""
    if swd_specs is None:
        return FLAT_SETS
    sph = [iwave for iwave, flsph in swd_specs if flsph == 1]
    return (int(any(flsph == 0 for _, flsph in swd_specs)),
            int(bool(sph)), int(1 in sph))


class Outputs(typing.NamedTuple):
    """K1's launch constants for nl slots, its RF targets and its
    dispersion sets: the ``specs`` and pack ``layout`` structs, the
    output buffer's ``rows`` and the row counts ``sizes`` of its planes
    in order (the flat props and [cm; bx; top], the spherical ones, the
    Love density plane — each where written — then each RF target's
    table and pack, which start at the rows ``specs`` names), and
    ``swd`` the (flat, sph, love, sph_row, love_row) fields of
    ``struct SwdSets``."""
    specs: _ext.RfSpecs
    layout: _ext.PackLayout
    rows: int
    sizes: tuple
    swd: tuple


def outputs(nl, rf_specs, sets=FLAT_SETS):
    """The :class:`Outputs` of K1 for nl slots, ``rf_specs`` and the
    dispersion ``sets`` of :func:`swd_sets` (csrc/prep.cu)."""
    flat, sph, love = sets
    flat = flat or not sph
    off = _rf.pack_offsets(nl)
    ncoef = (nl - 1) * 32
    sizes = ((4 * nl, 3) if flat else ()) + ((4 * nl, 3) if sph else ())
    sph_row = 4 * nl + 3 if flat and sph else 0
    love_row = sum(sizes) if love else 0
    sizes += (nl,) if love else ()
    swd = sizes
    sizes += (ncoef, off['rows']) * len(rf_specs)
    specs = _ext.RfSpecs(n=len(rf_specs))
    for s, (p, wave) in enumerate(rf_specs):
        specs.p[s] = float(p)
        specs.wave[s] = _rf.wave_index(wave)
        specs.coefs[s] = sum(sizes[:len(swd) + 2 * s])
        specs.pack[s] = specs.coefs[s] + ncoef
    return Outputs(specs, _ext.pack_layout(off), sum(sizes), sizes,
                   (int(flat), int(sph), int(love), sph_row, love_row))


@functools.lru_cache(maxsize=16)
def swd_struct(swd):
    """The ``struct SwdSets`` of an :class:`Outputs`' ``swd`` fields."""
    return _ext.SwdSets(*swd)


# the launch constants of the last few (nl, rf_specs): only the output
# pointers change from call to call
cached_outputs = functools.lru_cache(maxsize=16)(outputs)


@functools.lru_cache(maxsize=16)
def prior_cfg(priors):
    """The ``struct PriorCfg`` of a :class:`ModelPriors`."""
    mantle = priors.mantle or (0.0, 0.0)
    return _ext.PriorCfg(
        int(priors.layermin), int(priors.layermax), priors.vsmin,
        priors.vsmax, priors.zmin, priors.zmax, priors.thickmin,
        1.0 - (priors.lvz or 0.0), 1.0 + (priors.hvz or 0.0),
        int(priors.lvz is not None), int(priors.hvz is not None),
        float(mantle[0]), float(mantle[1]), int(priors.mantle is not None))


def item_stores(geo, C, nl, n_rf, block, model=True, sets=FLAT_SETS):
    """{output: (N,) int64 flat indices ``row * C + chain``, one entry
    per store}: every store that block ``block`` of K1's (``model``,
    with the dispersion ``sets`` of :func:`swd_sets`) or K6's launch
    under ``geo`` makes, from the kernels' index arithmetic.  Outputs:
    ``valid`` (1 row) for K1, the flat set's ``props`` (4 nl rows) and
    ``swd`` (cm, bx, top: 3 rows) where written, the spherical set's
    ``sph_props`` and ``sph_swd``, the Love density plane ``love_rho``
    (nl rows), and ``coefs<s>`` ((nl - 1) * 32 rows), ``pack<s>`` (the
    pack's rows) per RF target (K6: ``n_rf`` 1)."""
    off = _rf.pack_offsets(nl)
    c0 = block * geo.tile
    tc = min(geo.tile, C - c0)
    out = {}
    flat, sph, love = sets
    flat = flat or not sph

    def put(name, rows, chains):
        out.setdefault(name, []).append(
            (np.asarray(rows) * C + c0 + np.asarray(chains)).reshape(-1))

    if model:
        # the Voronoi pass stores the flat walker planes, one item per
        # slot
        k = np.arange(nl * tc)
        if flat:
            put('props', np.arange(4)[:, None] * nl + k // tc, k % tc)
        # the per-chain scans: validity, and the flat set's scalars
        k = np.arange((2 if flat else 1) * tc)
        put('valid', 0, k[k < tc])
        if flat:
            put('swd', np.arange(3)[:, None], k[k >= tc] - tc)
        if sph:
            # the spherical pass, one item per slot, then its scan's
            # chain items ahead of the RF flattening's slot items
            k = np.arange(nl * tc)
            put('sph_props', np.arange(4)[:, None] * nl + k // tc, k % tc)
            if love:
                put('love_rho', k // tc, k % tc)
            k = np.arange(tc + nl * tc)
            put('sph_swd', np.arange(3)[:, None], k[k < tc])
    n_if = (nl - 1) * tc
    chain_rows = np.array([off['t0'], off['depth']]
                          + list(off['hmat'] + np.arange(8))
                          + list(off['nt'] + np.arange(8)))[:, None]
    k = np.arange(rf_items(nl, tc, off))
    for s in range(n_rf if model else 1):
        ki = k[k < n_if]
        put('coefs%d' % s, (ki // tc) * 32 + np.arange(32)[:, None], ki % tc)
        kc = k[(k >= n_if) & (k < n_if + tc)] - n_if
        put('pack%d' % s, chain_rows, kc)
        q, c = np.divmod(k[k >= n_if + tc] - n_if - tc, tc)
        plane = np.array([off['h'], off['vp'], off['vs']])[
            np.minimum(q // nl, 2)]
        put('pack%d' % s, np.where(
            q < 3 * nl, plane + q % nl,
            np.where(q == 3 * nl, off['p'], off['depth'] + q - 3 * nl)), c)
    return {name: np.concatenate(parts) for name, parts in out.items()}


def _stack_pairs(mats):
    """4 matrices x 4 entries x (re, im) of (L, C) -> (L*32, C)."""
    comps = [x for mat in mats for entry in mat for x in entry]
    out = torch.stack(comps, dim=1)                     # (L, 32, C)
    return out.reshape(-1, out.shape[-1])


def sphere_operands_T(h, vp, vs, rho):
    """K1's spherical arm (``pallas_prep._swd_rows`` iflsph 1) on (NL, C)
    layer planes: (d, a, b, rho_R, rho_L), the flattened thickness,
    velocities and the Rayleigh (exponent -2.275) and Love (-5)
    densities.  Depths accumulate slot by slot, the halfspace slot's
    bottom 1 km below its top and its thickness 0; rho times exp(ex
    ln(2R / (r0 + r1))), the TPU kernel's form (the cold path's
    ``swd.sphere_flatten_T`` takes a power)."""
    nl = h.shape[0]
    acc = torch.zeros_like(h[0])
    zt, zb = [], []
    for i in range(nl):
        zt.append(acc)
        acc = acc + (h[i] if i < nl - 1 else torch.ones_like(acc))
        zb.append(acc)
    r = torch.full_like(h, _swd.EARTH_R)   # tensor / tensor: IEEE division
    r0 = r - torch.stack(zt)
    r1 = r - torch.stack(zb)
    d = _swd.EARTH_R * torch.log(r / r1) - _swd.EARTH_R * torch.log(r / r0)
    d = torch.cat([d[:-1], torch.zeros_like(d[-1:])], dim=0)
    tmp = (r + r) / (r0 + r1)
    lt = torch.log(tmp)
    return (d, vp * tmp, vs * tmp, rho * torch.exp(-2.275 * lt),
            rho * torch.exp(-5.0 * lt))


def _swd_set(d, a, b, rho):
    """(props, cm, bx, top) of one flattening's layer planes."""
    nl = d.shape[0]
    idx = torch.arange(nl, device=d.device, dtype=d.dtype)[:, None]
    cm, bx = _swd.lower_bound(a, b, dim=0)
    top = torch.amax(torch.where(d > 0.0, idx, torch.full_like(d, -1.0)),
                     dim=0)
    return torch.cat([d, a, b, rho], dim=0), cm, bx, top


def _per_target(swd_specs, flat, sph, love):
    """One (props, cm, bx, top, rho) per (iwave, flsph) spec: the set of
    its flattening, and the Love density plane for a spherical Love
    target (None: plane 3 of props)."""
    return tuple(
        (flat if flsph == 0 else sph) + (
            love if flsph == 1 and iwave == 1 else None,)
        for iwave, flsph in swd_specs)


def model_operands_plain(vs_t, z_t, n, vpvs, priors, rf_specs,
                         swd_specs=None, layers=False):
    """Plain twin of :func:`model_operands` (same arguments/results)."""
    h, vp, vs, rho = _vor.voronoi_to_layers_T(vs_t, z_t, n, vpvs,
                                              priors.mantle)
    valid = _vor.model_is_valid_T(vs_t, z_t, n, vpvs, priors.as_dict,
                                  priors.thickmin, priors.lvz, priors.hvz)
    flat = _swd_set(h, vp, vs, rho)
    rf = tuple(rf_operands_plain(h, vp, vs, rho, p, wave)
               for p, wave in rf_specs)
    planes = ((h, vp, vs, rho),) if layers else ()
    if swd_specs is None:
        return (valid, flat, rf) + planes
    sph = love = None
    if swd_sets(swd_specs)[1]:
        d, a, b, rho_r, love = sphere_operands_T(h, vp, vs, rho)
        sph = _swd_set(d, a, b, rho_r)
    return (valid, _per_target(swd_specs, flat, sph, love), rf) + planes


def rf_operands_plain(h, vp, vs, rho, p, wave_type=_rf.P_WAVE,
                      flattening=True):
    """Plain twin of :func:`rf_operands` (same arguments/results).
    Written without in-place writes, so that ``torch.func`` can
    differentiate through it (``ops/rf_pd.py``)."""
    nl, C = h.shape
    dt, dev = h.dtype, h.device
    idx = torch.arange(nl, device=dev, dtype=dt)[:, None]
    p_t = torch.tensor(p, dtype=dt, device=dev)
    if flattening:
        h, vp, vs, rho = _rf.flatten_model_T(h, vp, vs, rho)
    coefs = _stack_pairs(_rf.interface_coeffs(
        p_t, vp[:-1], vs[:-1], rho[:-1], vp[1:], vs[1:], rho[1:]))
    v = vp if wave_type == _rf.P_WAVE else vs
    qv = _rf.sqrt_relu(1.0 / (v * v) - p_t * p_t)
    sgn_h = torch.cat([h[:-1], -torch.ones_like(h[:1])], dim=0)
    t0 = _vor.running_sum(sgn_h * qv)[-1]
    real = ((h[:-1] > 0.0) | (vp[:-1] != vp[1:]) | (vs[:-1] != vs[1:])
            | (rho[:-1] != rho[1:]))
    depth = torch.amax(torch.where(real, idx[:-1], torch.zeros_like(
        idx[:-1])), dim=0)
    off = _rf.pack_offsets(nl)
    mats = [torch.stack([x for entry in mat for x in entry])
            for mat in (_rf.displacement(p_t, vp[0], vs[0]),
                        _rf.free_surface(p_t, vp[0], vs[0]))]
    # the rows in pack_offsets' order: h, vp, vs, p, t0, hmat, nt, depth,
    # then the zero padding
    pack = torch.cat([h, vp, vs, p_t.expand(1, C), t0[None]] + mats
                     + [depth[None],
                        torch.zeros((off['rows'] - off['depth'] - 1, C),
                                    dtype=dt, device=dev)], dim=0)
    return coefs, pack


def model_operands(vs_t, z_t, n, vpvs, priors, rf_specs, swd_specs=None,
                   layers=False):
    """Model operands of depth-sorted (NL, C) nuclei.

    ``n`` (C,) int32 nucleus counts, ``vpvs`` (C,); ``priors`` a
    :class:`ModelPriors`; ``rf_specs`` one (slowness in s/km, wave
    type) pair per RF target; ``swd_specs`` one (iwave, flsph) pair per
    dispersion target, or None.  Returns ``(valid, swd, rf)``: validity
    (C,) bool; without ``swd_specs`` the flat set's walker operands
    (props, cm, bx, top), with them one (props, cm, bx, top, rho) per
    spec — its flattening's set, and the Love density plane of a
    spherical Love target (else None: plane 3 of props); and a tuple of
    one (coefs, pack) per RF spec; all row views of one output buffer.
    With ``layers`` (a custom target's forward) a fourth result, the
    layered model's (NL, C) planes (h, vp, vs, rho): the flat set's
    props rows, which hold the layers before any flattening, so the
    kernel writes the flat set whatever the dispersion targets ask.
    CPU tensors run the plain twin; CUDA tensors launch the kernel (the
    spherical one when a spec asks for a spherical set)."""
    if vs_t.device.type == 'cpu':
        return model_operands_plain(vs_t, z_t, n, vpvs, priors, rf_specs,
                                    swd_specs, layers)
    dev = vs_t.device
    nl, C = vs_t.shape
    f32 = torch.float32
    _ext.require(vs_t, 'vs_t', dev, f32, (nl, C))
    _ext.require(z_t, 'z_t', dev, f32, (nl, C))
    _ext.require(n, 'n', dev, torch.int32, (C,))
    _ext.require(vpvs, 'vpvs', dev, f32, (C,))
    if len(rf_specs) > _ext.RF_MAX:
        raise ValueError('%d RF targets, the kernel serves at most %d'
                         % (len(rf_specs), _ext.RF_MAX))
    sets = swd_sets(swd_specs)
    if layers:
        sets = (1,) + sets[1:]
    lo = cached_outputs(nl, tuple(rf_specs), sets)
    geo = geometry(C, nl, len(rf_specs), True, bool(sets[1]))
    out = torch.empty((lo.rows, C), dtype=f32, device=dev)
    valid = torch.empty(C, dtype=torch.bool, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_prep(
            _ext.ptr(vs_t), _ext.ptr(z_t), _ext.ptr(n), _ext.ptr(vpvs),
            nl, C, prior_cfg(priors), lo.specs, swd_struct(lo.swd),
            lo.layout, geo.threads, geo.tile, geo.smem, _ext.ptr(valid),
            _ext.ptr(out), _ext.stream(dev))
    _ext.check(rc, 'prep')
    model_operands.launches += 1
    model_operands.sph_launches += sets[1]
    model_operands.layer_launches += layers
    # few view calls, not one per plane: each costs host time
    parts = out.split(lo.sizes)
    nswd = len(lo.sizes) - 2 * len(rf_specs)
    rf = tuple(zip(parts[nswd::2], parts[nswd + 1::2]))
    planes = (parts[0].unflatten(0, (4, nl)).unbind(),) if layers else ()
    if swd_specs is None:
        return (valid, (parts[0],) + parts[1].unbind(), rf) + planes
    flat_w, sph_w, love_w = lo.swd[:3]
    k = 0
    flat = sph = love = None
    if flat_w:
        flat = (parts[0],) + parts[1].unbind()
        k = 2
    if sph_w:
        sph = (parts[k],) + parts[k + 1].unbind()
        k += 2
    if love_w:
        love = parts[k]
    return (valid, _per_target(swd_specs, flat, sph, love), rf) + planes


model_operands.launches = 0        # every launch
model_operands.sph_launches = 0    # launches with a spherical set
model_operands.layer_launches = 0  # launches that return the layers


@functools.lru_cache(maxsize=16)
def _pack_layout(nl):
    off = _rf.pack_offsets(nl)
    return off, _ext.pack_layout(off)


def rf_operands(h, vp, vs, rho, p, wave_type=_rf.P_WAVE, flattening=True):
    """The RF operands (coefs, pack) of (NL, C) layer planes: rfmini
    flattening (unless ``flattening`` is False: the raw layers), the
    ((NL-1)*32, C) interface tables and the per-chain pack for
    incidence ``wave_type`` at slowness ``p`` (s/km), row views of one
    output buffer at the planes' dtype.  CPU tensors run the plain twin;
    CUDA tensors launch K6 (its flattened or its unflattened arm), its
    float32 or its float64 instance by the planes' dtype."""
    if h.device.type == 'cpu':
        return rf_operands_plain(h, vp, vs, rho, p, wave_type, flattening)
    dev = h.device
    nl, C = h.shape
    dt = h.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError('h has dtype %s, expected float32 or float64' % dt)
    f64 = dt == torch.float64
    for name, x in (('h', h), ('vp', vp), ('vs', vs), ('rho', rho)):
        _ext.require(x, name, dev, dt, (nl, C))
    off, layout = _pack_layout(nl)
    geo = geometry(C, nl, 1, False, elem=8 if f64 else 4)
    ncoef = (nl - 1) * 32
    out = torch.empty((ncoef + off['rows'], C), dtype=dt, device=dev)
    lib = _ext.load()
    entry = lib.bh_rf_prep_f64 if f64 else lib.bh_rf_prep
    with torch.cuda.device(dev):
        rc = entry(
            _ext.ptr(h), _ext.ptr(vp), _ext.ptr(vs), _ext.ptr(rho), nl, C,
            float(p), _rf.wave_index(wave_type), int(bool(flattening)),
            layout, geo.threads, geo.tile, geo.smem, _ext.ptr(out),
            _ext.stream(dev))
    _ext.check(rc, 'rf_prep')
    if f64:
        rf_operands.f64_launches += 1
    else:
        rf_operands.launches += 1
        rf_operands.unflat_launches += not flattening
    return out.split((ncoef, off['rows']))


rf_operands.launches = 0          # every float32 launch
rf_operands.unflat_launches = 0   # float32 launches of the unflattened arm
rf_operands.f64_launches = 0      # launches of the float64 instance
