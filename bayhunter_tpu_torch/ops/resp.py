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
"""

import numpy as np
import torch

from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import rf as _rf


def _outputs(coefs, pack, cut, nsamp):
    """Checked shapes (nl, C, pack offsets) and the four (C, cut)
    output planes of a kernel launch."""
    dev = coefs.device
    C = coefs.shape[1]
    nl = coefs.shape[0] // 32 + 1
    off = _rf.pack_offsets(nl)
    _ext.require(coefs, 'coefs', dev, torch.float32, ((nl - 1) * 32, C))
    _ext.require(pack, 'pack', dev, torch.float32, (off['rows'], C))
    if not 0 < cut <= nsamp // 2 + 1:
        raise ValueError('cut %d outside 1..%d' % (cut, nsamp // 2 + 1))
    return nl, C, off, tuple(torch.empty((C, cut), dtype=torch.float32,
                                         device=dev) for _ in range(4))


def resp_plain(coefs, pack, cut, nsamp, fsamp, wave_type=_rf.P_WAVE):
    """Plain twin of :func:`resp` (same arguments and results)."""
    return _rf.transmission_response(coefs, pack, cut, nsamp, fsamp,
                                     wave_type)


def resp(coefs, pack, cut, nsamp, fsamp, wave_type=_rf.P_WAVE):
    """(cz re, cz im, cr re, cr im), each (C, cut) float32, of the
    operands ``coefs`` ((NL-1)*32, C) and ``pack`` (rows, C) for
    incidence ``wave_type`` under uniform Q.  CPU tensors run the plain
    twin; CUDA tensors launch K3."""
    if coefs.device.type == 'cpu':
        return resp_plain(coefs, pack, cut, nsamp, fsamp, wave_type)
    wave = _rf.wave_index(wave_type)
    dev = coefs.device
    nl, C, off, outs = _outputs(coefs, pack, cut, nsamp)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_resp(
            _ext.ptr(coefs), _ext.ptr(pack), _ext.pack_layout(off), nl, C,
            int(cut), int(nsamp), wave, float(2.0 * np.pi * fsamp / nsamp),
            *(_ext.ptr(o) for o in outs), _ext.stream(dev))
    _ext.check(rc, 'resp')
    resp.launches += 1
    resp.sv_launches += wave
    return outs


resp.launches = 0         # every launch
resp.sv_launches = 0      # launches for SV incidence


def resp_q_plain(coefs, pack, qp, qs, cut, nsamp, fsamp,
                 wave_type=_rf.P_WAVE, fref=_rf.FREF):
    """Plain twin of :func:`resp_q` (same arguments and results)."""
    return _rf.transmission_response_q(coefs, pack, qp, qs, cut, nsamp,
                                       fsamp, wave_type, fref)


def resp_q(coefs, pack, qp, qs, cut, nsamp, fsamp, wave_type=_rf.P_WAVE,
           fref=_rf.FREF):
    """:func:`resp` with per-layer quality factors ``qp``, ``qs``
    ((NL, C) float32 planes) at reference frequency ``fref`` (Hz).
    CPU tensors run the plain twin; CUDA tensors launch K3r."""
    if coefs.device.type == 'cpu':
        return resp_q_plain(coefs, pack, qp, qs, cut, nsamp, fsamp,
                            wave_type, fref)
    wave = _rf.wave_index(wave_type)
    dev = coefs.device
    nl, C, off, outs = _outputs(coefs, pack, cut, nsamp)
    _ext.require(qp, 'qp', dev, torch.float32, (nl, C))
    _ext.require(qs, 'qs', dev, torch.float32, (nl, C))
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_resp_q(
            _ext.ptr(coefs), _ext.ptr(pack), _ext.ptr(qp), _ext.ptr(qs),
            _ext.pack_layout(off), nl, C, int(cut), int(nsamp), wave,
            float(2.0 * np.pi * fsamp / nsamp), float(2.0 * np.pi * fref),
            *(_ext.ptr(o) for o in outs), _ext.stream(dev))
    _ext.check(rc, 'resp_q')
    resp_q.launches += 1
    resp_q.sv_launches += wave
    return outs


resp_q.launches = 0       # every launch
resp_q.sv_launches = 0    # launches for SV incidence
