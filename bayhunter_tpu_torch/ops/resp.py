"""K3 and K3r: the receiver-function transmission responses — CUDA
kernels and plain twins.

Mirror ``bayhunter_tpu/ops/pallas_rf.py`` ``_resp_kernel``: one lane per
(chain, frequency < cut), P or SV incidence, operands from the model
kernel K1 (warm steps, the Gauss-cut lanes) or from K6 (cold
evaluation, all nsamp/2 + 1 lanes; the batched RF forward).

  * K3 (:func:`resp`), the packed mode (called from
    ``_resp_packed_t``): uniform Q, Qp 500, Qs 225 at 1 Hz.  Twin
    ``ops/rf.py`` :func:`transmission_response`.
  * K3r (:func:`resp_q`), the row-major array-Q arm (called from
    ``transmission_response_pallas``): per-layer (NL, C) Qp/Qs planes
    and any reference frequency.  Twin ``ops/rf.py``
    :func:`transmission_response_q`.

Both take the ``options`` bitmask of the JAX package's XLA ``synrf``
(``rf.SUPPRESS_MULTIPLES``, ``rf.WITHOUT_ANELASTICITY``), one kernel
instance per value; their twins take the same argument.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import lanes as _lanes
from bayhunter_tpu_torch.ops import rf as _rf

MAX_THREADS = 256   # csrc/resp.cu RESP_MAX_THREADS
MIN_THREADS = 128
MAX_TILE = 5        # chains per block where F is not small
N_SCALARS = 20      # csrc/resp.cu N_SC: p, p^2, t0, depth, hmat, nt


class Geometry(NamedTuple):
    """Launch geometry of K3/K3r: ``threads`` per block, ``tile`` whole
    chains per block, ``blocks``, the floats ``cs`` of one chain's
    shared-memory record and the dynamic shared bytes ``smem``."""
    threads: int
    tile: int
    blocks: int
    cs: int
    smem: int


def record_floats(nl, q):
    """Floats of one chain's record in csrc/resp.cu: the coefficient
    rows, 3 (K3) or 7 (K3r) per-layer planes and the scalars, padded to
    4 mod 32 so that the staging stores of consecutive chains fall in
    different banks and each record stays 16-byte aligned."""
    need = (nl - 1) * 32 + (7 if q else 3) * nl + N_SCALARS
    return 4 + 32 * -(-(need - 4) // 32)


@functools.lru_cache(maxsize=64)
def geometry(C, F, nl, q=False, elem=4):
    """K3's (``q`` False) or K3r's launch geometry for C chains of F
    frequency lanes and nl layer slots, ``elem`` the bytes of the scalar
    type (8 for K3's float64 instances): among tiles of at most
    ``MAX_TILE`` whole chains (more where F is small; at least two blocks
    per SM where C allows) and blocks of 128-256 threads, the pair that
    wastes the fewest thread slots on a tile's last, partial warp, then
    the fewest rounds."""
    cs = record_floats(nl, q)
    max_tile = max(1, min(max(MAX_TILE, MAX_THREADS // F),
                          -(-C // (2 * _lanes.SMS))))
    best = None
    for tile in range(1, max_tile + 1):
        smem = elem * tile * cs + 16              # + the staged-row count
        if smem > _lanes.SMEM_MAX and tile > 1:
            break
        warps = -(-tile * F // _lanes.WARP)
        for threads in range(MIN_THREADS, MAX_THREADS + 1, _lanes.WARP):
            rounds = -(-warps // (threads // _lanes.WARP))
            key = (tile * F / (rounds * threads), -rounds)
            if best is None or key > best[0]:
                best = (key, Geometry(threads, tile, -(-C // tile), cs,
                                      smem))
    geo = best[1]
    if geo.smem > _lanes.SMEM_MAX:
        raise ValueError('RF response: %d layer slots need %d bytes of '
                         'shared memory, above %d'
                         % (nl, geo.smem, _lanes.SMEM_MAX))
    return geo


def lane_map(geo, C, F):
    """(blocks, rounds, threads) int64: the lane ``chain * F + f`` that
    each thread serves in each round, -1 where it idles — the kernel's
    map: the tile's lanes in order, a warp straddling two chains where F
    is not a multiple of 32."""
    T, tile, B = geo.threads, geo.tile, geo.blocks
    rounds = -(-tile * F // T)
    j = np.arange(rounds * T)
    cc = j // F
    lanes = np.arange(B)[:, None] * tile * F + j
    tc = np.minimum(tile, C - np.arange(B) * tile)
    lanes[cc[None, :] >= tc[:, None]] = -1
    return lanes.reshape(B, rounds, T)


def lane_work(C, F, nl, depth, q=False):
    """(executed, useful) layer-lanes of a launch
    (:func:`lanes.executed_work`, one trip per lane): ``depth`` (C,) the
    skip depths the kernel runs (layers 0..depth)."""
    depth = np.minimum(np.asarray(depth, np.int64), nl - 2)
    lm = lane_map(geometry(C, F, nl, q), C, F)
    return _lanes.executed_work(lm, np.ones(C * F, np.int64),
                                np.repeat(depth + 1, F))


def _outputs(coefs, pack, cut, nsamp, dtype=torch.float32):
    """Checked shapes (nl, C, pack offsets) and the four (C, cut)
    output planes of a kernel launch at ``dtype``."""
    dev = coefs.device
    C = coefs.shape[1]
    nl = coefs.shape[0] // 32 + 1
    off = _rf.pack_offsets(nl)
    _ext.require(coefs, 'coefs', dev, dtype, ((nl - 1) * 32, C))
    _ext.require(pack, 'pack', dev, dtype, (off['rows'], C))
    if not 0 < cut <= nsamp // 2 + 1:
        raise ValueError('cut %d outside 1..%d' % (cut, nsamp // 2 + 1))
    return nl, C, off, tuple(torch.empty((C, cut), dtype=dtype, device=dev)
                             for _ in range(4))


def resp_plain(coefs, pack, cut, nsamp, fsamp, wave_type=_rf.P_WAVE,
               options=0):
    """Plain twin of :func:`resp` (same arguments and results)."""
    return _rf.transmission_response(coefs, pack, cut, nsamp, fsamp,
                                     wave_type, options)


def resp(coefs, pack, cut, nsamp, fsamp, wave_type=_rf.P_WAVE, options=0):
    """(cz re, cz im, cr re, cr im), each (C, cut) at the operands'
    dtype, of the operands ``coefs`` ((NL-1)*32, C) and ``pack`` (rows,
    C) for incidence ``wave_type`` under uniform Q, or with the
    ``options`` bitmask (``rf.options_index``).  CPU tensors run the
    plain twin; CUDA tensors launch K3, its float32 or its float64
    instance by the operands' dtype (``launches``, ``sv_launches`` and
    ``option_launches`` count the former, ``f64_launches`` and
    ``f64_sv_launches`` the latter)."""
    if coefs.device.type == 'cpu':
        return resp_plain(coefs, pack, cut, nsamp, fsamp, wave_type,
                          options)
    wave = _rf.wave_index(wave_type)
    opt = _rf.options_index(options)
    dev = coefs.device
    dt = coefs.dtype
    f64 = dt == torch.float64
    nl, C, off, outs = _outputs(coefs, pack, cut, nsamp,
                                torch.float64 if f64 else torch.float32)
    geo = geometry(C, int(cut), nl, elem=8 if f64 else 4)
    lib = _ext.load()
    entry = lib.bh_resp_f64 if f64 else lib.bh_resp
    with torch.cuda.device(dev):
        rc = entry(
            _ext.ptr(coefs), _ext.ptr(pack), _ext.pack_layout(off), nl, C,
            int(cut), int(nsamp), wave, opt,
            float(2.0 * np.pi * fsamp / nsamp), geo.threads, geo.tile,
            geo.cs, geo.smem, *(_ext.ptr(o) for o in outs),
            _ext.stream(dev))
    _ext.check(rc, 'resp')
    if f64:
        resp.f64_launches += 1
        resp.f64_sv_launches += wave
        return outs
    resp.launches += 1
    resp.sv_launches += wave
    resp.option_launches[wave][opt] += 1
    return outs


resp.launches = 0         # every float32 launch
resp.sv_launches = 0      # float32 launches for SV incidence
# float32 launches by incidence (P, SV) and options bitmask
resp.option_launches = [[0] * 4, [0] * 4]
resp.f64_launches = 0     # every launch of the float64 instances
resp.f64_sv_launches = 0  # float64 launches for SV incidence


def resp_q_plain(coefs, pack, qp, qs, cut, nsamp, fsamp,
                 wave_type=_rf.P_WAVE, fref=_rf.FREF, options=0):
    """Plain twin of :func:`resp_q` (same arguments and results)."""
    return _rf.transmission_response_q(coefs, pack, qp, qs, cut, nsamp,
                                       fsamp, wave_type, fref, options)


def resp_q(coefs, pack, qp, qs, cut, nsamp, fsamp, wave_type=_rf.P_WAVE,
           fref=_rf.FREF, options=0):
    """:func:`resp` with per-layer quality factors ``qp``, ``qs``
    ((NL, C) float32 planes) at reference frequency ``fref`` (Hz).
    CPU tensors run the plain twin; CUDA tensors launch K3r."""
    if coefs.device.type == 'cpu':
        return resp_q_plain(coefs, pack, qp, qs, cut, nsamp, fsamp,
                            wave_type, fref, options)
    wave = _rf.wave_index(wave_type)
    opt = _rf.options_index(options)
    dev = coefs.device
    nl, C, off, outs = _outputs(coefs, pack, cut, nsamp)
    _ext.require(qp, 'qp', dev, torch.float32, (nl, C))
    _ext.require(qs, 'qs', dev, torch.float32, (nl, C))
    geo = geometry(C, int(cut), nl, True)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_resp_q(
            _ext.ptr(coefs), _ext.ptr(pack), _ext.ptr(qp), _ext.ptr(qs),
            _ext.pack_layout(off), nl, C, int(cut), int(nsamp), wave, opt,
            float(2.0 * np.pi * fsamp / nsamp), float(2.0 * np.pi * fref),
            geo.threads, geo.tile, geo.cs, geo.smem,
            *(_ext.ptr(o) for o in outs), _ext.stream(dev))
    _ext.check(rc, 'resp_q')
    resp_q.launches += 1
    resp_q.sv_launches += wave
    resp_q.option_launches[wave][opt] += 1
    return outs


resp_q.launches = 0       # every launch
resp_q.sv_launches = 0    # launches for SV incidence
# launches by incidence (P, SV) and options bitmask
resp_q.option_launches = [[0] * 4, [0] * 4]
