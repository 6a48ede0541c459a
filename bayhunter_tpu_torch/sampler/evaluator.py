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

Ported target kinds: the four dispersion targets of the reference
(Rayleigh and Love, phase and group velocity), on a flat or a
spherical earth, of any mode, of any number of periods (more than 60
are solved at 60 evenly spaced and interpolated, ``_TargetSpec``
``interp_x``), and P and S receiver functions with the top-layer or a
fixed (``nsv``) rotation velocity, under every law of
``_covariance_kind``: the uncorrelated law (corr fixed to 0, no data
errors), the uncorrelated law with relatively scaled data errors (corr
fixed to 0, positive ``yerr``), the exponential law (corr inverted,
read per chain from the noise state, or an SWD corr fixed nonzero) and
the whitened Gaussian law (RF corr fixed nonzero).  Each target reads
its forward parameters from its plugin's ``modelparams``
(``target.moddata.plugin``), as the JAX evaluator does.  Each RF target
has its own slowness, wave type and Gauss-cut tables, and the model
kernel builds one operand set per RF target and one dispersion set per
flattening present.  The optional mantle prior (vs threshold, mantle
vp/vs) applies on the cold path (``voronoi_to_layers``) and in K1.  A
custom target (no dispersion or RF ref) calls its plugin's batched
forward ``run_model_torch(h, vp, vs, rho) -> y``: (C, NL) padded layer
tensors on the chains' device in (halfspace last, zero-thickness
padding), a (C, ndata) tensor out, non-finite values marking a failed
forward (``templates/myfwd.py``); its layers come from
``voronoi_to_layers`` on the cold path and from K1 in a step.

Observed data may be one row (ndata,) or, for tomography-scale batched
inversions, a matrix (ncells, ndata) (``_TargetSpec.batched_obs``,
``:139-143``): each chain is then scored against the row of its
``cell`` (``yobs_for``), gathered once per target and evaluation by one
``index_select``.

Kernels on each path: the cold evaluation runs K4 (Rayleigh) or K5
(Love) for every secular evaluation of its counting search and
refinement, and K6 then K3 over all nsamp/2 + 1 frequencies for each
RF target; a warm step of the batch path runs K1 (its spherical kernel
when a target is spherical), K2 per dispersion target (a group target's
2P lanes with 12 bisections; a spherical Love target on K1's Love
density plane) and K3 over the Gauss-cut frequencies per RF target; a
custom target adds no kernel (K1 returns the layers).  A warm step of
the per-chain ring path (``eval_full``; the path of float64 runs, as in
the JAX package) runs what the cold evaluation runs, its search the
ring from the cached roots; in float64 every kernel is its double
instance.
"""

import numpy as np
import torch

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
SWD_REFS = {'rdispph': (2, 0), 'ldispph': (1, 0),
            'rdispgr': (2, 1), 'ldispgr': (1, 1)}
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
                 dof_correction=False, dtype=torch.float32):
        self.ref = target.ref
        self.kind = 'swd' if target.ref in SWD_REFS else \
            'rf' if target.ref in RF_WAVES else 'custom'
        # (ndata,) for one station, or (ncells, ndata) for batched
        # observations, each chain reading the row of its cell
        self.yobs = torch.tensor(target.obsdata.y, dtype=dtype,
                                 device=device)
        self.batched_obs = self.yobs.dim() == 2
        self.ndata = int(self.yobs.shape[-1])
        self.cov = _covariance_kind(target, corr_fixed, corr_value)
        plugin = target.moddata.plugin
        if self.kind == 'swd':
            self.iwave, self.igr = SWD_REFS[target.ref]
            self.mode = int(plugin.modelparams.get('mode', 1))
            self.flsph = int(plugin.modelparams.get('flsph', 0))
            obsx = np.asarray(target.obsdata.x, float)
            np_dtype = np.float64 if dtype == torch.float64 else np.float32
            self.interp_x = None
            if obsx.size > 60:
                # the reference's 60-period cap, then interpolation
                # (src/surf96_modsw.py:35-43, 106-122)
                self.periods = np.linspace(obsx.min(), obsx.max(),
                                           60).astype(np_dtype)
                self.interp_x = torch.tensor(obsx, dtype=dtype,
                                             device=device)
            else:
                self.periods = obsx.astype(np_dtype)
            self.t, lanes = _swd.lane_periods(self.periods, self.igr,
                                              device, dtype)
            self.omegas = _swd.angular_frequencies(lanes, device, dtype)
        elif self.kind == 'rf':
            mp = plugin.modelparams
            self.wave_type = RF_WAVES[target.ref]
            self.fsamp, self.tshift = float(plugin.fsamp), \
                float(plugin.tshft)
            self.nsamp = int(plugin.nsamp)
            self.gauss_a = float(mp['gauss'])
            self.p_skm = float(mp['p']) * _rf.DEG_PER_KM
            self.nsv = None if mp.get('nsv') is None else float(mp['nsv'])
            self.cut = _rf.gauss_cut(self.nsamp, self.fsamp, self.gauss_a)
            self.dft = _rf.dft_tables(self.cut, self.nsamp, self.fsamp,
                                      self.tshift, self.gauss_a, device,
                                      dtype)
        else:
            self.forward = getattr(plugin, 'run_model_torch', None)
            if self.forward is None:
                raise NotImplementedError(
                    'custom target %r: its forward plugin must define '
                    'run_model_torch(h, vp, vs, rho) -> y, the batched '
                    'counterpart of the JAX package\'s run_model_jax: '
                    '(C, NL) padded layer tensors in, a (C, ndata) tensor '
                    'out, non-finite values marking a failed forward (see '
                    'bayhunter_tpu_torch/templates/myfwd.py)' % target.ref)
        if self.cov == 'gauss':
            self.dof_correction = bool(dof_correction)
            w, logdet = lk.gauss_whitener(corr_value, self.ndata,
                                          rcond=rcond,
                                          return_kept=self.dof_correction)
            self.whitener = torch.tensor(w, dtype=dtype, device=device)
            self.logcorr_det = float(logdet)
        elif self.cov == 'nocorr_scalederr':
            yerr = np.asarray(target.obsdata.yerr, float)
            scaled = yerr / yerr.min()
            self.scaled_err = torch.tensor(scaled, dtype=dtype,
                                           device=device)
            self.log_scalederr_sum = float(np.sum(np.log(scaled)))

    def yobs_for(self, cell):
        """The observed data each chain is scored against: the (C,
        ndata) rows of ``cell`` for batched observations, else the one
        (ndata,) row."""
        if not self.batched_obs:
            return self.yobs
        if cell is None:
            raise ValueError('target %r has batched (ncells, ndata) '
                             'observations: pass each chain\'s cell'
                             % self.ref)
        return self.yobs.index_select(0, cell.to(torch.int64))

    def loglike(self, ydiff, sigma, corr=None, wide=None):
        """The target's law on (C, n) residuals; ``sigma`` and ``corr``
        (C,) from the noise state (``corr`` is read by the exponential
        law only); ``wide`` runs the Gaussian law's product
        (``Evaluator._wide``)."""
        if self.cov == 'exp':
            return lk.loglike_exp(ydiff, sigma, corr)
        if self.cov == 'nocorr':
            return lk.loglike_nocorr(ydiff, sigma)
        if self.cov == 'nocorr_scalederr':
            return lk.loglike_nocorr_scalederr(ydiff, sigma,
                                               self.scaled_err,
                                               self.log_scalederr_sum)
        if self.dof_correction:
            return lk.loglike_gauss_white_dof(ydiff, sigma, self.whitener,
                                              self.logcorr_det, wide)
        return lk.loglike_gauss_white(ydiff, sigma, self.whitener,
                                      self.logcorr_det, wide)

    def interpolated(self, cg):
        """Velocities at the solved periods, at the observed ones: the
        same, or interpolated from the 60 solved past 60."""
        if self.interp_x is None:
            return cg
        return _swd.interp(self.interp_x, self.t, cg)

    def swd_output(self, c, found):
        """(y, tvalid) of a dispersion solve's lane roots: the phase or
        group velocities zero-filled from the first failed period, at
        the observed periods."""
        cg, err = _swd.velocities(c, found, self.t, self.igr)
        return self.interpolated(cg), ~err


class Evaluator:
    """Joint-target evaluators sharing a forward cache.

      eval_cold(vs, z, n, vpvs, noise, cell)        row-major (C, NL)
          -> (logL, misfits, valid, cache)           full root search
      eval_noise(noise, cache, cell) -> (logL, valid)  cached synthetics
      eval_full_batch_t(vs_t, z_t, n, vpvs, noise, cache, warm, cell)
          -> (logL, misfits, valid, cache, model_valid)
                                                     (NL, C) models
      eval_full(vs, z, n, vpvs, noise, cache, ring, cell)
          -> (logL, misfits, valid, cache)           row-major (C, NL)

    ``cell`` (C,) int32 selects each chain's row of batched observations
    and may be None when no target has them.

    Two warm paths, as the JAX package's ``build_evaluator`` has them
    (``use_batch_swd``): the batch path ``eval_full_batch_t`` (K1, K2,
    K3 at the Gauss-cut lanes; float32 only), and the per-chain ring
    path ``eval_full`` (``bayhunter_tpu/sampler/evaluator.py:252-282``):
    each dispersion target solved from its cached roots by the pure
    expanding ring of half-width ``ring`` and the refinement
    (``swd.surfdisp_roots_warm``: K4 or K5), each RF target as the cold
    evaluation computes it (K6, then K3 at all nsamp/2 + 1 lanes and the
    inverse FFT), a custom target's forward on ``voronoi_to_layers``;
    its ring covers the search range, so no proposal is rejected for a
    bounded walk.  ``dtype`` is
    the evaluation's (float32 or float64: the kernels' double instances)
    and ``batch`` whether the batch path is built (float32 only).

    In a worker of a split run ``rows`` (``chain.Rows``, set with the
    sampler's) places the chains in the whole batch: the cold chunks
    follow the one-device run's grid of ``COLD_CHUNK`` rows, and the
    row-wise operations whose rounding of a row depends on the batch's
    shape (the Gaussian law's and the RF DFT's matrix products, the cold
    RF's FFT) run at the width of the one-device run's call, the rows at
    their place in it (:meth:`_wide`), so that every chain evaluates as
    it does there.
    """

    def __init__(self, joint, priors, initparams, nl, device,
                 dtype=torch.float32, use_batch_swd=True):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError('dtype %s: the evaluator runs float32 or '
                             'float64' % dtype)
        if use_batch_swd and dtype != torch.float32:
            raise ValueError('the batch path (K1, K2) runs float32 only; '
                             'a %s evaluator takes the per-chain ring path '
                             '(use_batch_swd=False)' % dtype)
        self.nl = int(nl)
        self.device = torch.device(device)
        self.dtype = dtype
        self.batch = bool(use_batch_swd)
        mantle = priors.get('mantle')
        self.mantle = None if mantle is None \
            else (float(mantle[0]), float(mantle[1]))
        rcond = initparams.get('rcond', None)
        dof = bool(initparams.get('gauss_dof_correction', False))
        self.specs = []
        for target in joint.targets:
            corr_prior = priors[target.noiseref + 'noise_corr']
            corr_fixed = isinstance(corr_prior, (int, float))
            self.specs.append(TargetSpec(
                target, corr_fixed, float(corr_prior) if corr_fixed
                else None, rcond, self.device, dof_correction=dof,
                dtype=dtype))
        # the (slowness, wave type) of each RF target, in target order:
        # the model kernel builds one operand set per entry
        self.rf_specs = tuple((s.p_skm, s.wave_type) for s in self.specs
                              if s.kind == 'rf')
        # the (iwave, flsph) of each dispersion target, in target order:
        # the model kernel builds one set per flattening present
        self.swd_specs = tuple((s.iwave, s.flsph) for s in self.specs
                               if s.kind == 'swd')
        # a custom target's forward takes the layered model from K1
        self.layers = any(s.kind == 'custom' for s in self.specs)
        self.priors = _prep.ModelPriors(
            int(priors['layers'][0]), int(priors['layers'][1]),
            float(priors['vs'][0]), float(priors['vs'][1]),
            float(priors['z'][0]), float(priors['z'][1]),
            float(initparams['thickmin']),
            _opt(initparams.get('lvz', priors.get('lvz'))),
            _opt(initparams.get('hvz', priors.get('hvz'))), self.mantle)
        self.ntargets = len(self.specs)
        self.rows = None        # a split run's row block (chain.Rows)

    def _wide(self, place=None):
        """``wide(fn, *xs)``: ``fn(*xs)`` of a row-wise ``fn`` on (C, ...)
        tensors, run in a worker's block at the one-device run's width,
        the rows at their offset and zeros elsewhere.  ``place`` is
        (offset, width) of these rows in the one-device run's call, the
        whole batch's (``rows``) by default."""
        if place is None and self.rows is not None:
            place = (self.rows.start, self.rows.total)

        def wide(fn, *xs):
            n = xs[0].shape[0]
            if place is None or place == (0, n):
                return fn(*xs)
            off, width = place
            full = []
            for x in xs:
                f = x.new_zeros((width,) + tuple(x.shape[1:]))
                f[off:off + n] = x
                full.append(f)
            return fn(*full)[off:off + n]
        return wide

    # ------------------------------------------------------------------

    def _score(self, ys, tvalids, noise, cell, wide):
        """logL, misfits and validity from per-target synthetics."""
        C = noise.shape[0]
        logL = torch.zeros(C, dtype=self.dtype, device=noise.device)
        valid = torch.ones(C, dtype=torch.bool, device=noise.device)
        misfits = []
        for i, (spec, y, tvalid) in enumerate(zip(self.specs, ys,
                                                  tvalids)):
            ydiff = torch.where(tvalid[:, None], y - spec.yobs_for(cell),
                                torch.zeros_like(y))
            misfits.append(torch.sqrt(torch.mean(ydiff * ydiff, dim=-1)))
            logL = logL + spec.loglike(ydiff, noise[:, 2 * i + 1],
                                       noise[:, 2 * i], wide)
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

    def _empty(self, C, device):
        return torch.zeros((C, 0), dtype=self.dtype, device=device)

    def _custom(self, spec, h, vp, vs, rho):
        """(y, tvalid) of a custom target's forward on (C, NL) layers."""
        y = torch.as_tensor(spec.forward(h, vp, vs, rho), dtype=self.dtype,
                            device=h.device)
        return y, torch.isfinite(y).all(dim=-1)

    def _rf_time_series(self, spec, response, pack, cold, wide):
        rf = _rf.receiver_function(response, pack, self.nl, spec.nsamp,
                                   spec.fsamp, spec.tshift, spec.gauss_a,
                                   None if cold else spec.dft,
                                   spec.wave_type, spec.nsv, wide)
        y = rf[:, :spec.ndata]
        return y, torch.isfinite(y).all(dim=-1)

    # ------------------------------------------------------------------

    def eval_cold(self, vs, z, n, vpvs, noise, cell=None):
        """Cold evaluation of row-major (C, NL) models, in chunks of
        ``COLD_CHUNK`` rows of the whole batch."""
        return self._chunks(vs, z, n, vpvs, noise, cell)

    def eval_full(self, vs, z, n, vpvs, noise, cache, ring, cell=None):
        """Warm evaluation of row-major (C, NL) proposals on the per-chain
        ring path (the JAX ``eval_full``): each dispersion target from
        its cached roots ``cache[i][1]`` by the ring of half-width
        ``ring`` (:func:`swd.surfdisp_roots_warm`), each RF and custom
        target as :meth:`eval_cold` computes it; in chunks of
        ``COLD_CHUNK`` rows, as :meth:`eval_cold`."""
        return self._chunks(vs, z, n, vpvs, noise, cell, cache, ring)

    def _chunks(self, vs, z, n, vpvs, noise, cell, cache=None, ring=None):
        """:meth:`_eval_rows` on chunks of ``COLD_CHUNK`` rows of the
        whole batch (a worker's rows on the one-device run's grid),
        concatenated."""
        C = vs.shape[0]
        first, total = (0, C) if self.rows is None \
            else (self.rows.start, self.rows.total)
        parts = []
        for g in range(first - first % COLD_CHUNK, first + C, COLD_CHUNK):
            a, b = max(g, first) - first, min(g + COLD_CHUNK, first + C) \
                - first
            place = (a + first - g, min(g + COLD_CHUNK, total) - g)
            parts.append(self._eval_rows(
                vs[a:b], z[a:b], n[a:b], vpvs[a:b], noise[a:b],
                None if cell is None else cell[a:b], self._wide(place),
                None if cache is None else tuple(
                    tuple(x[a:b] for x in entry) for entry in cache),
                ring))
        cache = tuple(tuple(torch.cat([p[3][t][k] for p in parts])
                            for k in range(3))
                      for t in range(self.ntargets))
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]), cache)

    def _eval_rows(self, vs, z, n, vpvs, noise, cell, wide, cache=None,
                   ring=None):
        """One chunk: cold without ``cache``, else warm from its roots on
        the ring of half-width ``ring``."""
        C = vs.shape[0]
        h, vp, vs_l, rho = _vor.voronoi_to_layers(vs, z, n, vpvs,
                                                  self.mantle)
        ys, tvalids, new_cache = [], [], []
        for i, spec in enumerate(self.specs):
            if spec.kind == 'swd':
                if cache is None:
                    cg, err, roots, slopes = _swd.surfdisp_roots_cold(
                        h, vp, vs_l, rho, spec.periods, spec.iwave,
                        spec.mode, spec.igr, spec.flsph)
                else:
                    cg, err, roots, slopes = _swd.surfdisp_roots_warm(
                        h, vp, vs_l, rho, spec.periods, cache[i][1], ring,
                        spec.iwave, spec.mode, spec.igr, spec.flsph)
                y = spec.interpolated(cg)
                ys.append(y)
                tvalids.append(~err)
                new_cache.append((y, roots, slopes))
                continue
            if spec.kind == 'custom':
                y, tvalid = self._custom(spec, h, vp, vs_l, rho)
                ys.append(y)
                tvalids.append(tvalid)
                new_cache.append((y, self._empty(C, vs.device),
                                  self._empty(C, vs.device)))
                continue
            coefs, pack = _prep.rf_operands(
                *(x.T.contiguous() for x in (h, vp, vs_l, rho)), spec.p_skm,
                spec.wave_type)
            response = _resp.resp(coefs, pack, spec.nsamp // 2 + 1,
                                  spec.nsamp, spec.fsamp, spec.wave_type)
            y, tvalid = self._rf_time_series(spec, response, pack,
                                             True, wide)
            ys.append(y)
            tvalids.append(tvalid)
            new_cache.append((y, self._empty(C, vs.device),
                              self._empty(C, vs.device)))
        logL, misfits, valid = self._score(ys, tvalids, noise, cell, wide)
        return logL, misfits, valid, tuple(new_cache)

    def eval_noise(self, noise, cache, cell=None):
        """Likelihood under new noise parameters from the cached
        synthetics (a noise move leaves the model unchanged)."""
        ys = [c[0] for c in cache]
        tvalids = [torch.isfinite(y).all(dim=-1) for y in ys]
        logL, _, valid = self._score(ys, tvalids, noise, cell, self._wide())
        return logL, valid

    def eval_full_batch_t(self, vs_t, z_t, n, vpvs, noise, cache, warm,
                          cell=None):
        """Warm evaluation of transposed (NL, C) proposals through the
        three kernels: K1 model operands, K2 walker per dispersion
        target on K1's planes (``warm``: a ``swd.WARM_*`` setting), K3
        response per RF target on its own K1 operand set, a custom
        target's forward on K1's layers.  The last result is the
        kernel's prior validity."""
        C = vs_t.shape[1]
        wide = self._wide()
        mvalid, swd_ops, rf_ops, *layers = _prep.model_operands(
            vs_t, z_t, n, vpvs, self.priors, self.rf_specs, self.swd_specs,
            self.layers)
        swd_ops, rf_ops = iter(swd_ops), iter(rf_ops)
        ys, tvalids, new_cache = [], [], []
        for spec, (_, roots, slopes) in zip(self.specs, cache):
            if spec.kind == 'swd':
                props, cm, bx, top, rho = next(swd_ops)
                c, found, slopes_n = _swd.warm_solve(
                    props, cm, bx, top, spec.omegas, roots, warm,
                    slope_prev=slopes, iwave=spec.iwave, rho=rho,
                    group=bool(spec.igr))
                y, tvalid = spec.swd_output(c, found)
                ys.append(y)
                tvalids.append(tvalid)
                new_cache.append((y, c, slopes_n))
                continue
            if spec.kind == 'custom':
                y, tvalid = self._custom(spec, *(x.T for x in layers[0]))
                ys.append(y)
                tvalids.append(tvalid)
                new_cache.append((y, self._empty(C, y.device),
                                  self._empty(C, y.device)))
                continue
            coefs, pack = next(rf_ops)
            response = _resp.resp(coefs, pack, spec.cut, spec.nsamp,
                                  spec.fsamp, spec.wave_type)
            y, tvalid = self._rf_time_series(spec, response, pack,
                                             False, wide)
            ys.append(y)
            tvalids.append(tvalid)
            new_cache.append((y, self._empty(C, y.device),
                              self._empty(C, y.device)))
        logL, misfits, valid = self._score(ys, tvalids, noise, cell, wide)
        return logL, misfits, valid, tuple(new_cache), mvalid


def _opt(x):
    return None if x is None else float(x)


def build_evaluator(joint, priors, initparams, nl, device,
                    dtype=torch.float32, use_batch_swd=True):
    """The :class:`Evaluator` of a joint target on ``device`` at
    ``dtype``, with the batch path (``use_batch_swd``, float32 only) or
    the per-chain ring path alone."""
    return Evaluator(joint, priors, initparams, nl, device, dtype,
                     use_batch_swd)
