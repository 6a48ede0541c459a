"""K3: the receiver-function transmission response — CUDA kernel and
plain twin.

Mirrors ``bayhunter_tpu/ops/pallas_rf.py`` ``_resp_kernel`` in packed
mode (driver ``_resp_packed_t``): one lane per (chain, frequency <
cut), P incidence, uniform Q, operands from the model kernel (warm
steps, the Gauss-cut lanes) or from K6 (cold evaluation, all nsamp/2 + 1
lanes).  The plain twin is ``ops/rf.py`` :func:`transmission_response`.
"""

import numpy as np
import torch

from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import rf as _rf


def resp_plain(coefs, pack, cut, nsamp, fsamp):
    """Plain twin of :func:`resp` (same arguments and results)."""
    return _rf.transmission_response(coefs, pack, cut, nsamp, fsamp)


def resp(coefs, pack, cut, nsamp, fsamp):
    """(cz re, cz im, cr re, cr im), each (C, cut) float32, of the
    model kernel's ``coefs`` ((NL-1)*32, C) and ``pack`` (rows, C).
    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    if coefs.device.type == 'cpu':
        return resp_plain(coefs, pack, cut, nsamp, fsamp)
    dev = coefs.device
    C = coefs.shape[1]
    nl = coefs.shape[0] // 32 + 1
    f32 = torch.float32
    off = _rf.pack_offsets(nl)
    _ext.require(coefs, 'coefs', dev, f32, ((nl - 1) * 32, C))
    _ext.require(pack, 'pack', dev, f32, (off['rows'], C))
    if not 0 < cut <= nsamp // 2 + 1:
        raise ValueError('cut %d outside 1..%d' % (cut, nsamp // 2 + 1))
    outs = tuple(torch.empty((C, cut), dtype=f32, device=dev)
                 for _ in range(4))
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_resp(
            _ext.ptr(coefs), _ext.ptr(pack), _ext.pack_layout(off), nl, C,
            int(cut), int(nsamp), float(2.0 * np.pi * fsamp / nsamp),
            *(_ext.ptr(o) for o in outs), _ext.stream(dev))
    _ext.check(rc, 'resp')
    resp.launches += 1
    return outs


resp.launches = 0
