"""K1: the model kernel, and K6: its RF operands alone — CUDA kernels
and plain twins.

Mirrors ``bayhunter_tpu/ops/pallas_prep.py`` (``_model_kernel``,
``model_operands_t``) for flat-earth dispersion targets and any number
(up to ``_ext.RF_MAX``) of receiver-function targets with flattening,
each given as a (slowness, wave type) spec as the JAX kernel's
``specs`` tuple gives it.  From depth-sorted (NL, C) nucleus planes it
computes, per chain:

  * the prior validity (layer count, thickness, vs bounds, interface
    depths, optional low/high-velocity-zone limits);
  * the walker planes [d; a; b; rho] (4 NL, C), the lower bound cm,
    betmx and the deepest layer ``top`` (-1 for a pure halfspace);
  * per RF target, the rfmini-flattened RF operands: the ((NL-1)*32, C)
    interface table (row l*32 + m*8 + e*2 + c for matrix m in (rd, td,
    ru, tu), entry e in (11, 12, 21, 22), re/im c) and the per-chain
    pack (rows named by ``rf.pack_offsets``; its t0 is the direct P or
    S arrival time).

K6 (``rf_operands``) computes the last item from (NL, C) layer planes
for the cold evaluation, as ``pallas_prep.rf_operands_t`` does; both
kernels share its device code (``csrc/prep.cu`` ``rf_item``).

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
    """Static prior bounds the model kernel checks."""
    layermin: int
    layermax: int
    vsmin: float
    vsmax: float
    zmin: float
    zmax: float
    thickmin: float
    lvz: typing.Optional[float]
    hvz: typing.Optional[float]

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


def tile_floats(nl, model=True):
    """Shared floats per chain of K1's (``model``) or K6's tile: K1's
    raw vs and z, its layered (then flattened) h, vp, vs, rho, the
    running depths (nl + 1) and vpvs and n; K6's layer planes and
    running depths."""
    return 7 * nl + 3 if model else 5 * nl + 1


def rf_items(nl, tc, off):
    """Items of one RF target in a tile of ``tc`` chains: an item per
    interface, one per chain, one per stored pack row that is not the
    chain item's (the h, vp, vs planes, the slowness, the padding)."""
    return (nl - 1) * tc + tc + (3 * nl + 1 + off['rows'] - off['depth']
                                 - 1) * tc


@functools.lru_cache(maxsize=64)
def geometry(C, nl, n_rf, model=True):
    """K1's (``model``) or K6's launch geometry for C chains of nl layer
    slots and ``n_rf`` RF targets (K6: 1): tiles of 32 chains where that
    gives at least two blocks per SM, else of 16 (a 2,048-chain cold
    chunk: 128 blocks), and enough threads for a tile's items up to
    ``MAX_THREADS``."""
    tile = next((t for t in TILES if -(-C // t) >= 2 * _lanes.SMS
                 and 4 * tile_floats(nl, model) * t <= _lanes.SMEM_MAX),
                TILES[-1])
    smem = 4 * tile_floats(nl, model) * tile
    if smem > _lanes.SMEM_MAX:
        raise ValueError('%s: %d layer slots need %d bytes of shared '
                         'memory, above %d' % ('K1' if model else 'K6', nl,
                                               smem, _lanes.SMEM_MAX))
    work = max(nl * tile, n_rf * rf_items(nl, tile, _rf.pack_offsets(nl)))
    threads = min(MAX_THREADS, -(-work // _lanes.WARP) * _lanes.WARP)
    return Geometry(threads, tile, -(-C // tile), smem)


class Outputs(typing.NamedTuple):
    """K1's launch constants for nl slots and its RF targets: the
    ``specs`` and pack ``layout`` structs, and the output buffer's
    ``rows`` and the row counts ``sizes`` of its planes in order (props,
    [cm; bx; top], then each target's table and pack, which start at
    the rows ``specs`` names)."""
    specs: _ext.RfSpecs
    layout: _ext.PackLayout
    rows: int
    sizes: tuple


def outputs(nl, rf_specs):
    """The :class:`Outputs` of K1 for nl slots and ``rf_specs``
    (csrc/prep.cu)."""
    off = _rf.pack_offsets(nl)
    ncoef = (nl - 1) * 32
    sizes = (4 * nl, 3) + (ncoef, off['rows']) * len(rf_specs)
    specs = _ext.RfSpecs(n=len(rf_specs))
    for s, (p, wave) in enumerate(rf_specs):
        specs.p[s] = float(p)
        specs.wave[s] = _rf.wave_index(wave)
        specs.coefs[s] = sum(sizes[:2 + 2 * s])
        specs.pack[s] = specs.coefs[s] + ncoef
    return Outputs(specs, _ext.pack_layout(off), sum(sizes), sizes)


# the launch constants of the last few (nl, rf_specs): only the output
# pointers change from call to call
cached_outputs = functools.lru_cache(maxsize=16)(outputs)


@functools.lru_cache(maxsize=16)
def prior_cfg(priors):
    """The ``struct PriorCfg`` of a :class:`ModelPriors`."""
    return _ext.PriorCfg(
        int(priors.layermin), int(priors.layermax), priors.vsmin,
        priors.vsmax, priors.zmin, priors.zmax, priors.thickmin,
        1.0 - (priors.lvz or 0.0), 1.0 + (priors.hvz or 0.0),
        int(priors.lvz is not None), int(priors.hvz is not None))


def item_stores(geo, C, nl, n_rf, block, model=True):
    """{output: (N,) int64 flat indices ``row * C + chain``, one entry
    per store}: every store that block ``block`` of K1's (``model``) or
    K6's launch under ``geo`` makes, from the kernels' index arithmetic.
    Outputs: ``props`` (4 nl rows), ``valid`` (1 row), ``swd`` (cm, bx,
    top: 3 rows) for K1, and ``coefs<s>`` ((nl - 1) * 32 rows),
    ``pack<s>`` (the pack's rows) per RF target (K6: ``n_rf`` 1)."""
    off = _rf.pack_offsets(nl)
    c0 = block * geo.tile
    tc = min(geo.tile, C - c0)
    out = {}

    def put(name, rows, chains):
        out.setdefault(name, []).append(
            (np.asarray(rows) * C + c0 + np.asarray(chains)).reshape(-1))

    if model:
        # the Voronoi pass stores the walker planes, one item per slot
        k = np.arange(nl * tc)
        put('props', np.arange(4)[:, None] * nl + k // tc, k % tc)
        # the two per-chain scans
        k = np.arange(2 * tc)
        put('valid', 0, k[k < tc])
        put('swd', np.arange(3)[:, None], k[k >= tc] - tc)
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


def model_operands_plain(vs_t, z_t, n, vpvs, priors, rf_specs):
    """Plain twin of :func:`model_operands` (same arguments/results)."""
    nl, C = vs_t.shape
    dt, dev = vs_t.dtype, vs_t.device
    h, vp, vs, rho = _vor.voronoi_to_layers_T(vs_t, z_t, n, vpvs)
    valid = _vor.model_is_valid_T(vs_t, z_t, n, vpvs, priors.as_dict,
                                  priors.thickmin, priors.lvz, priors.hvz)
    cm, bx = _swd.lower_bound(vp, vs, dim=0)
    idx = torch.arange(nl, device=dev, dtype=dt)[:, None]
    top = torch.amax(torch.where(h > 0.0, idx, torch.full_like(h, -1.0)),
                     dim=0)
    props = torch.cat([h, vp, vs, rho], dim=0)
    return (valid, (props, cm, bx, top),
            tuple(rf_operands_plain(h, vp, vs, rho, p, wave)
                  for p, wave in rf_specs))


def rf_operands_plain(h, vp, vs, rho, p, wave_type=_rf.P_WAVE):
    """Plain twin of :func:`rf_operands` (same arguments/results)."""
    nl, C = h.shape
    dt, dev = h.dtype, h.device
    idx = torch.arange(nl, device=dev, dtype=dt)[:, None]
    p_t = torch.tensor(p, dtype=dt, device=dev)
    hf, vpf, vsf, rhof = _rf.flatten_model_T(h, vp, vs, rho)
    coefs = _stack_pairs(_rf.interface_coeffs(
        p_t, vpf[:-1], vsf[:-1], rhof[:-1], vpf[1:], vsf[1:], rhof[1:]))
    v = vpf if wave_type == _rf.P_WAVE else vsf
    qv = torch.sqrt(torch.clamp(1.0 / (v * v) - p_t * p_t, min=0.0))
    sgn_h = torch.cat([hf[:-1], -torch.ones_like(hf[:1])], dim=0)
    t0 = _vor.running_sum(sgn_h * qv)[-1]
    real = ((hf[:-1] > 0.0) | (vpf[:-1] != vpf[1:]) | (vsf[:-1] != vsf[1:])
            | (rhof[:-1] != rhof[1:]))
    depth = torch.amax(torch.where(real, idx[:-1], torch.zeros_like(
        hf[:-1])), dim=0)
    off = _rf.pack_offsets(nl)
    pack = torch.zeros((off['rows'], C), dtype=dt, device=dev)
    for name, plane in (('h', hf), ('vp', vpf), ('vs', vsf)):
        pack[off[name]:off[name] + nl] = plane
    pack[off['p']] = p_t
    pack[off['t0']] = t0
    for name, mat in (('hmat', _rf.displacement(p_t, vpf[0], vsf[0])),
                      ('nt', _rf.free_surface(p_t, vpf[0], vsf[0]))):
        pack[off[name]:off[name] + 8] = torch.stack(
            [x for entry in mat for x in entry])
    pack[off['depth']] = depth
    return coefs, pack


def model_operands(vs_t, z_t, n, vpvs, priors, rf_specs):
    """Model operands of depth-sorted (NL, C) nuclei.

    ``n`` (C,) int32 nucleus counts, ``vpvs`` (C,); ``priors`` a
    :class:`ModelPriors`; ``rf_specs`` one (slowness in s/km, wave
    type) pair per RF target.  Returns ``(valid, (props, cm, bx, top),
    rf)``: validity (C,) bool, the SWD walker operands and a tuple of
    one (coefs, pack) per RF spec, row views of one output buffer.  CPU
    tensors run the plain twin; CUDA tensors launch the kernel."""
    if vs_t.device.type == 'cpu':
        return model_operands_plain(vs_t, z_t, n, vpvs, priors, rf_specs)
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
    lo = cached_outputs(nl, tuple(rf_specs))
    geo = geometry(C, nl, len(rf_specs))
    out = torch.empty((lo.rows, C), dtype=f32, device=dev)
    valid = torch.empty(C, dtype=torch.bool, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_prep(
            _ext.ptr(vs_t), _ext.ptr(z_t), _ext.ptr(n), _ext.ptr(vpvs),
            nl, C, prior_cfg(priors), lo.specs, lo.layout, geo.threads,
            geo.tile, geo.smem, _ext.ptr(valid), _ext.ptr(out),
            _ext.stream(dev))
    _ext.check(rc, 'prep')
    model_operands.launches += 1
    # two view calls, not one per plane: each costs host time
    props, swd, *rf = out.split(lo.sizes)
    return (valid, (props,) + swd.unbind(),
            tuple(zip(rf[0::2], rf[1::2])))


model_operands.launches = 0


@functools.lru_cache(maxsize=16)
def _pack_layout(nl):
    off = _rf.pack_offsets(nl)
    return off, _ext.pack_layout(off)


def rf_operands(h, vp, vs, rho, p, wave_type=_rf.P_WAVE):
    """The RF operands (coefs, pack) of (NL, C) layer planes: rfmini
    flattening, the ((NL-1)*32, C) interface tables and the per-chain
    pack for incidence ``wave_type`` at slowness ``p`` (s/km), row
    views of one output buffer.  CPU tensors run the plain twin; CUDA
    tensors launch K6."""
    if h.device.type == 'cpu':
        return rf_operands_plain(h, vp, vs, rho, p, wave_type)
    dev = h.device
    nl, C = h.shape
    f32 = torch.float32
    for name, x in (('h', h), ('vp', vp), ('vs', vs), ('rho', rho)):
        _ext.require(x, name, dev, f32, (nl, C))
    off, layout = _pack_layout(nl)
    geo = geometry(C, nl, 1, False)
    ncoef = (nl - 1) * 32
    out = torch.empty((ncoef + off['rows'], C), dtype=f32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_rf_prep(
            _ext.ptr(h), _ext.ptr(vp), _ext.ptr(vs), _ext.ptr(rho), nl, C,
            float(p), _rf.wave_index(wave_type), layout, geo.threads,
            geo.tile, geo.smem, _ext.ptr(out), _ext.stream(dev))
    _ext.check(rc, 'rf_prep')
    rf_operands.launches += 1
    return out.split((ncoef, off['rows']))


rf_operands.launches = 0
