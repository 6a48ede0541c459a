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
kernels share its device code (``csrc/prep.cu`` ``rf_rows``).
"""

import typing

import torch

from bayhunter_tpu_torch.ops import _ext
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
    one (coefs, pack) per RF spec.  CPU tensors run the plain twin;
    CUDA tensors launch the kernel."""
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
    off = _rf.pack_offsets(nl)
    valid = torch.empty(C, dtype=torch.bool, device=dev)
    props = torch.empty((4 * nl, C), dtype=f32, device=dev)
    cm, bx, top = (torch.empty(C, dtype=f32, device=dev) for _ in range(3))
    rf = tuple((torch.empty(((nl - 1) * 32, C), dtype=f32, device=dev),
                torch.empty((off['rows'], C), dtype=f32, device=dev))
               for _ in rf_specs)
    specs = _ext.RfSpecs(n=len(rf_specs))
    for s, ((p, wave), (coefs, pack)) in enumerate(zip(rf_specs, rf)):
        specs.p[s] = float(p)
        specs.wave[s] = _rf.wave_index(wave)
        specs.coefs[s] = coefs.data_ptr()
        specs.pack[s] = pack.data_ptr()
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_prep(
            _ext.ptr(vs_t), _ext.ptr(z_t), _ext.ptr(n), _ext.ptr(vpvs),
            nl, C, int(priors.layermin), int(priors.layermax),
            priors.vsmin, priors.vsmax, priors.zmin, priors.zmax,
            priors.thickmin,
            1.0 - (priors.lvz or 0.0), 1.0 + (priors.hvz or 0.0),
            int(priors.lvz is not None), int(priors.hvz is not None),
            specs, _ext.pack_layout(off), _ext.ptr(valid),
            _ext.ptr(props), _ext.ptr(cm), _ext.ptr(bx), _ext.ptr(top),
            _ext.stream(dev))
    _ext.check(rc, 'prep')
    model_operands.launches += 1
    return valid, (props, cm, bx, top), rf


model_operands.launches = 0


def rf_operands(h, vp, vs, rho, p, wave_type=_rf.P_WAVE):
    """The RF operands (coefs, pack) of (NL, C) layer planes: rfmini
    flattening, the ((NL-1)*32, C) interface tables and the per-chain
    pack for incidence ``wave_type`` at slowness ``p`` (s/km).  CPU
    tensors run the plain twin; CUDA tensors launch K6."""
    if h.device.type == 'cpu':
        return rf_operands_plain(h, vp, vs, rho, p, wave_type)
    dev = h.device
    nl, C = h.shape
    f32 = torch.float32
    for name, x in (('h', h), ('vp', vp), ('vs', vs), ('rho', rho)):
        _ext.require(x, name, dev, f32, (nl, C))
    off = _rf.pack_offsets(nl)
    coefs = torch.empty(((nl - 1) * 32, C), dtype=f32, device=dev)
    pack = torch.empty((off['rows'], C), dtype=f32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        rc = lib.bh_rf_prep(
            _ext.ptr(h), _ext.ptr(vp), _ext.ptr(vs), _ext.ptr(rho), nl, C,
            float(p), _rf.wave_index(wave_type), _ext.pack_layout(off),
            _ext.ptr(coefs), _ext.ptr(pack), _ext.stream(dev))
    _ext.check(rc, 'rf_prep')
    rf_operands.launches += 1
    return coefs, pack


rf_operands.launches = 0
