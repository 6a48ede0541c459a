"""Batched joint-target evaluator.

Mirrors ``bayhunter_tpu/sampler/evaluator.py`` (``_TargetSpec``,
``build_evaluator``: ``eval_cold``, ``eval_noise`` and
``eval_full_batch_t`` with the unified model kernel), including the
sentinels (logL = -1e15, misfits = 1e15 on an invalid forward
solution) and the forward cache: one ``(y, roots, slopes)`` 3-tuple per
target — the synthetic data of the current model and, for dispersion
targets, the roots that warm-start the next solve and their bracket
slopes (0.0 = no cache), which seed the Newton recentering of vs moves
only.

Ported target kinds: fundamental-mode Rayleigh and Love phase
dispersion on a flat earth (at most 60 periods each) and P and S
receiver functions, with the uncorrelated law (corr fixed to 0, no data
errors) or the whitened Gaussian law (RF corr fixed nonzero).  Each RF
target has its own slowness, wave type and Gauss-cut tables, and the
model kernel builds one operand set per RF target.

Kernels on each path: the cold evaluation runs K4 (Rayleigh) or K5
(Love) for every secular evaluation of its counting search and
refinement, and K6 then K3 over all nsamp/2 + 1 frequencies for each
RF target; a warm step runs K1, K2 per dispersion target (both wave
types on K1's planes) and K3 over the Gauss-cut frequencies per RF
target.
"""

import numpy as np
import torch

from bayhunter_tpu_torch import DTYPE
from bayhunter_tpu_torch.ops import likelihood as lk
from bayhunter_tpu_torch.ops import prep as _prep
from bayhunter_tpu_torch.ops import resp as _resp
from bayhunter_tpu_torch.ops import rf as _rf
from bayhunter_tpu_torch.ops import swd as _swd
from bayhunter_tpu_torch.ops import voronoi as _vor

LOGL_SENTINEL = -1e15
MISFIT_SENTINEL = 1e15
COLD_CHUNK = 2048       # chains per cold-solve chunk (bounds the
#                         (C, periods, 64) candidate grids)
RF_WAVES = {'prf': _rf.P_WAVE, 'srf': _rf.SV_WAVE}


def _covariance_kind(target, corr_fixed, corr_value):
    """``bayhunter_tpu/sampler/evaluator.py:117-127``."""
    if not corr_fixed:
        return 'exp'
    if corr_value == 0 and np.any(np.isnan(target.obsdata.yerr)):
        return 'nocorr'
    if corr_value == 0:
        return 'nocorr_scalederr'
    if target.noiseref == 'rf':
        return 'gauss'
    return 'exp'


class TargetSpec:
    """Host-precomputed constants of one target, on ``device``."""

    def __init__(self, target, corr_fixed, corr_value, rcond, device,
                 dof_correction=False):
        self.kind = target.noiseref
        self.yobs = torch.tensor(target.obsdata.y, dtype=DTYPE,
                                 device=device)
        self.ndata = int(self.yobs.shape[-1])
        self.cov = _covariance_kind(target, corr_fixed, corr_value)
        if self.cov not in ('nocorr', 'gauss'):
            raise NotImplementedError(
                'likelihood law %r is not ported yet' % self.cov)
        if self.kind == 'swd':
            if (target.igr != 0
                    or target.modelparams['mode'] != 1
                    or target.modelparams['flsph'] != 0
                    or target.obsdata.x.size > 60):
                raise NotImplementedError(
                    'only fundamental-mode Rayleigh and Love phase '
                    'velocity on a flat earth (<= 60 periods) is ported')
            self.iwave = int(target.iwave)
            self.periods = np.asarray(target.obsdata.x, np.float32)
            self.omegas = _swd.angular_frequencies(self.periods, device)
        else:
            mp = target.modelparams
            if target.ref not in RF_WAVES or mp['nsv'] is not None:
                raise NotImplementedError(
                    'only P and S receiver functions with the top-layer '
                    'rotation velocity are ported')
            self.wave_type = RF_WAVES[target.ref]
            self.fsamp, self.tshift = target.fsamp, target.tshft
            self.nsamp = target.nsamp
            self.gauss_a = float(mp['gauss'])
            self.p_skm = float(mp['p']) * _rf.DEG_PER_KM
            self.cut = _rf.gauss_cut(self.nsamp, self.fsamp, self.gauss_a)
            self.dft = _rf.dft_tables(self.cut, self.nsamp, self.fsamp,
                                      self.tshift, self.gauss_a, device)
        if self.cov == 'gauss':
            self.dof_correction = bool(dof_correction)
            w, logdet = lk.gauss_whitener(corr_value, self.ndata,
                                          rcond=rcond,
                                          return_kept=self.dof_correction)
            self.whitener = torch.tensor(w, dtype=DTYPE, device=device)
            self.logcorr_det = float(logdet)

    def loglike(self, ydiff, sigma):
        if self.cov == 'nocorr':
            return lk.loglike_nocorr(ydiff, sigma)
        if self.dof_correction:
            return lk.loglike_gauss_white_dof(ydiff, sigma, self.whitener,
                                              self.logcorr_det)
        return lk.loglike_gauss_white(ydiff, sigma, self.whitener,
                                      self.logcorr_det)


class Evaluator:
    """Joint-target evaluators sharing a forward cache.

      eval_cold(vs, z, n, vpvs, noise)              row-major (C, NL)
          -> (logL, misfits, valid, cache)           full root search
      eval_noise(noise, cache) -> (logL, valid)      cached synthetics
      eval_full_batch_t(vs_t, z_t, n, vpvs, noise, cache, warm)
          -> (logL, misfits, valid, cache, model_valid)
                                                     (NL, C) models
    """

    def __init__(self, joint, priors, initparams, nl, device):
        self.nl = int(nl)
        self.device = torch.device(device)
        if priors.get('mantle') is not None:
            raise NotImplementedError('the mantle vp/vs prior is not '
                                      'ported yet')
        rcond = initparams.get('rcond', None)
        dof = bool(initparams.get('gauss_dof_correction', False))
        self.specs = []
        for target in joint.targets:
            corr_prior = priors[target.noiseref + 'noise_corr']
            corr_fixed = isinstance(corr_prior, (int, float))
            self.specs.append(TargetSpec(
                target, corr_fixed, float(corr_prior) if corr_fixed
                else None, rcond, self.device, dof_correction=dof))
        # the (slowness, wave type) of each RF target, in target order:
        # the model kernel builds one operand set per entry
        self.rf_specs = tuple((s.p_skm, s.wave_type) for s in self.specs
                              if s.kind == 'rf')
        self.priors = _prep.ModelPriors(
            int(priors['layers'][0]), int(priors['layers'][1]),
            float(priors['vs'][0]), float(priors['vs'][1]),
            float(priors['z'][0]), float(priors['z'][1]),
            float(initparams['thickmin']),
            _opt(initparams.get('lvz', priors.get('lvz'))),
            _opt(initparams.get('hvz', priors.get('hvz'))))
        self.ntargets = len(self.specs)

    # ------------------------------------------------------------------

    def _score(self, ys, tvalids, noise):
        """logL, misfits and validity from per-target synthetics."""
        C = noise.shape[0]
        logL = torch.zeros(C, dtype=DTYPE, device=noise.device)
        valid = torch.ones(C, dtype=torch.bool, device=noise.device)
        misfits = []
        for i, (spec, y, tvalid) in enumerate(zip(self.specs, ys,
                                                  tvalids)):
            ydiff = torch.where(tvalid[:, None], y - spec.yobs,
                                torch.zeros_like(y))
            misfits.append(torch.sqrt(torch.mean(ydiff * ydiff, dim=-1)))
            logL = logL + spec.loglike(ydiff, noise[:, 2 * i + 1])
            valid = valid & tvalid
        valid = valid & torch.isfinite(logL)
        total = misfits[0]
        for m in misfits[1:]:
            total = total + m
        misfits = torch.stack(misfits + [total], dim=-1)
        logL = torch.where(valid, logL,
                           torch.full_like(logL, LOGL_SENTINEL))
        misfits = torch.where(valid[:, None], misfits,
                              torch.full_like(misfits, MISFIT_SENTINEL))
        return logL, misfits, valid

    @staticmethod
    def _empty(C, device):
        return torch.zeros((C, 0), dtype=DTYPE, device=device)

    def _rf_time_series(self, spec, response, pack, cold):
        rf = _rf.receiver_function(response, pack, self.nl, spec.nsamp,
                                   spec.fsamp, spec.tshift, spec.gauss_a,
                                   None if cold else spec.dft,
                                   spec.wave_type)
        y = rf[:, :spec.ndata]
        return y, torch.isfinite(y).all(dim=-1)

    # ------------------------------------------------------------------

    def eval_cold(self, vs, z, n, vpvs, noise):
        """Cold evaluation of row-major (C, NL) models, in chunks."""
        C = vs.shape[0]
        parts = [self._eval_cold(vs[i:i + COLD_CHUNK],
                                 z[i:i + COLD_CHUNK], n[i:i + COLD_CHUNK],
                                 vpvs[i:i + COLD_CHUNK],
                                 noise[i:i + COLD_CHUNK])
                 for i in range(0, C, COLD_CHUNK)]
        cache = tuple(tuple(torch.cat([p[3][t][k] for p in parts])
                            for k in range(3))
                      for t in range(self.ntargets))
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]), cache)

    def _eval_cold(self, vs, z, n, vpvs, noise):
        C = vs.shape[0]
        h, vp, vs_l, rho = _vor.voronoi_to_layers(vs, z, n, vpvs)
        ys, tvalids, cache = [], [], []
        for spec in self.specs:
            if spec.kind == 'swd':
                cg, err, roots, slopes = _swd.surfdisp_roots_cold(
                    h, vp, vs_l, rho, spec.periods, spec.iwave)
                ys.append(cg)
                tvalids.append(~err)
                cache.append((cg, roots, slopes))
                continue
            coefs, pack = _prep.rf_operands(
                *(x.T.contiguous() for x in (h, vp, vs_l, rho)), spec.p_skm,
                spec.wave_type)
            response = _resp.resp(coefs, pack, spec.nsamp // 2 + 1,
                                  spec.nsamp, spec.fsamp, spec.wave_type)
            y, tvalid = self._rf_time_series(spec, response, pack,
                                             cold=True)
            ys.append(y)
            tvalids.append(tvalid)
            cache.append((y, self._empty(C, vs.device),
                          self._empty(C, vs.device)))
        logL, misfits, valid = self._score(ys, tvalids, noise)
        return logL, misfits, valid, tuple(cache)

    def eval_noise(self, noise, cache):
        """Likelihood under new noise parameters from the cached
        synthetics (a noise move leaves the model unchanged)."""
        ys = [c[0] for c in cache]
        tvalids = [torch.isfinite(y).all(dim=-1) for y in ys]
        logL, _, valid = self._score(ys, tvalids, noise)
        return logL, valid

    def eval_full_batch_t(self, vs_t, z_t, n, vpvs, noise, cache, warm):
        """Warm evaluation of transposed (NL, C) proposals through the
        three kernels: K1 model operands, K2 walker per dispersion
        target on K1's planes (``warm``: a ``swd.WARM_*`` setting), K3
        response per RF target on its own K1 operand set.  The last
        result is the kernel's prior validity."""
        C = vs_t.shape[1]
        mvalid, (props, cm, bx, top), rf_ops = _prep.model_operands(
            vs_t, z_t, n, vpvs, self.priors, self.rf_specs)
        rf_ops = iter(rf_ops)
        ys, tvalids, new_cache = [], [], []
        for spec, (_, roots, slopes) in zip(self.specs, cache):
            if spec.kind == 'swd':
                cg, err, roots_n, slopes_n = _swd.warm_solve(
                    props, cm, bx, top, spec.omegas, roots, warm,
                    slope_prev=slopes, iwave=spec.iwave)
                ys.append(cg)
                tvalids.append(~err)
                new_cache.append((cg, roots_n, slopes_n))
                continue
            coefs, pack = next(rf_ops)
            response = _resp.resp(coefs, pack, spec.cut, spec.nsamp,
                                  spec.fsamp, spec.wave_type)
            y, tvalid = self._rf_time_series(spec, response, pack,
                                             cold=False)
            ys.append(y)
            tvalids.append(tvalid)
            new_cache.append((y, self._empty(C, y.device),
                              self._empty(C, y.device)))
        logL, misfits, valid = self._score(ys, tvalids, noise)
        return logL, misfits, valid, tuple(new_cache), mvalid


def _opt(x):
    return None if x is None else float(x)


def build_evaluator(joint, priors, initparams, nl, device):
    """The :class:`Evaluator` of a joint target on ``device``."""
    return Evaluator(joint, priors, initparams, nl, device)
