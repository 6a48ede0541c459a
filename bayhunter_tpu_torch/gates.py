"""The JAX package's statistical gates of the sampler, run on the port.

Each gate is the port's counterpart of a JAX test, with that test's
numpy recipe copied here (the port imports nothing of the JAX package)
and its bands unchanged:

  * :func:`dim_reject_pin` — ``tests/test_dim_reject_pin.py``: two
    rounds of a birth then a death step from a seeded ensemble of grown
    5-8 layer models (:func:`grown_models`) in the bench configuration
    (Rayleigh phase + P-RF, nl 21), 128 chains; the dimension moves'
    forward rejects per direction in ``PIN_BANDS``;
  * :func:`converged_band` — ``tests/test_dim_reject_converged.py``: the
    tutorial's captured late-phase snapshot
    (``tests/fixtures/converged_state_st3.npz``) tiled 12 times, birth,
    death, birth, death; the dimension-reject rate inside
    ``CONVERGED_BAND``;
  * :func:`walker_golden` — ``tests/test_swd_sweep.py``
    ``test_walker_warm_refinement_error_bounded``: vs-move perturbations
    of the pathology models, warm-solved (K2) from the unperturbed
    models' cold roots, against a float64 golden of the perturbed
    models; ``WALKER_BOUNDS``;
  * :func:`prior_histogram` — ``tests/test_sampler.py``
    ``test_prior_only_dispatch_cycles_uniform_layer_histogram``: a
    constant likelihood through ``dispatch_cycles`` samples a uniform
    layer count, every bin within ``PRIOR_TOL`` of uniform.

The port has one dimension move, the per-chain fair birth/death mixture
(``chain.MOVE_DIM``); a birth (death) step here is that move with every
chain's coin set to birth (death), its other randoms drawn from the
sampler's generator.  Each gate returns a dict of what it measured with
``ok`` (inside the bands); :func:`check` raises on a gate that is not.
The gates run on any device: on the CPU through the kernels' plain
twins, on CUDA through the kernels."""

import dataclasses
import os

import numpy as np
import torch

from bayhunter_tpu_torch import bench_config
from bayhunter_tpu_torch.ops import prep
from bayhunter_tpu_torch.ops import swd
from bayhunter_tpu_torch.sampler import chain

CONVERGED = os.path.join(bench_config.FIXTURES, 'converged_state_st3.npz')

# tests/test_dim_reject_pin.py:127-129 (percent, inclusive)
PIN_CHAINS = 128
PIN_ITERS = 4096          # the pin's iter_burnin (sets the chains' iiter)
PIN_BANDS = {'birth': (0.0, 10.0), 'death': (12.0, 33.0),
             'combined': (5.0, 17.0)}
# tests/test_dim_reject_converged.py:96 (percent, exclusive)
CONVERGED_REPS = 12
CONVERGED_BAND = (6.0, 22.0)
# tests/test_swd_sweep.py:268-274
WALKER_BOUNDS = {'lanes': 250, 'median': 2e-6, 'p99': 2e-5,
                 'outlier': 1.5e-3, 'outlier_share': 0.01}
# tests/test_sampler.py: 40 segments of 100 late iterations, the first
# 15 dropped, every bin within 0.035 of uniform
PRIOR_SEGMENT = 100
PRIOR_SEGMENTS = 40
PRIOR_DROP = 15
PRIOR_TOL = 0.035
# the prior-only widths of that test: wide birth/death proposals, the
# width adaptation off
PRIOR_INITPARAMS = {'propdist': (0.05, 0.05, 1.0, 0.005, 0.005),
                    'acceptance': (0.0, 100.0), 'thickmin': 0.1,
                    'lvz': None, 'hvz': None, 'rcond': 1e-5,
                    'iter_burnin': 1000, 'iter_main': 1000}


# ----------------------------------------------------------------------
# (g-1), (g-2): the dimension moves' forward rejects
# ----------------------------------------------------------------------

def grown_models(C, nl, seed=3):
    """(VS, Z, N) of ``C`` seeded 5-8 layer models around the tutorial
    truth: the draws of ``tests/test_dim_reject_pin.py``
    ``_grown_states`` (``RandomState(3)``), its (C, nl) float32 nuclei
    padded as the port's states are (``Sampler.init_states_host``: the
    last velocity, depth 120 = 2 zmax) where the JAX test pads zeros."""
    rs = np.random.RandomState(seed)
    VS = np.zeros((C, nl), np.float32)
    Z = np.zeros((C, nl), np.float32)
    N = np.zeros(C, np.int32)
    for i in range(C):
        nex = rs.randint(1, 5)
        n = 4 + nex
        znuc = np.sort(np.concatenate([
            np.array([2.5, 15., 32., 48.]) + rs.uniform(-1.5, 1.5, 4),
            rs.uniform(1., 58., nex)]))
        vsn = np.interp(znuc, [0, 5, 5.01, 28, 28.01, 36, 36.01, 60],
                        [2.7, 2.7, 3.6, 3.6, 3.8, 3.8, 4.4, 4.4])
        vsn = vsn + rs.normal(0, 0.05, n)
        VS[i, :n] = np.sort(vsn)
        Z[i, :n] = znuc
        VS[i, n:] = VS[i, n - 1]
        Z[i, n:] = 120.0
        N[i] = n
    return VS, Z, N


def pin_sampler(device):
    """The pin's configuration (``_bench_config_sampler``: Rayleigh
    phase + P-RF fixtures, ``bench_config.PRIORS``, propdist 0.015 /
    0.015 / 0.015 / 0.005 / 0.005, nl 21) as the port's sampler."""
    return bench_config.build(device, iters=PIN_ITERS, nl=21)[0]


def _with_models(sampler, states, vs, z, n, **fields):
    """``states`` holding the (C, NL) models ``vs``, ``z``, ``n``,
    evaluated cold (K4, K6, K3 at all lanes), at the states' floating
    type."""
    dev, dt = states.n.device, states.vs.dtype
    vs, z = (torch.tensor(np.asarray(x, np.float32), device=dev).to(dt)
             for x in (vs, z))
    n = torch.tensor(np.asarray(n, np.int32), device=dev)
    fields = {k: torch.tensor(np.asarray(v, np.float32), device=dev).to(dt)
              for k, v in fields.items()}
    vpvs = fields.get('vpvs', states.vpvs)
    noise = fields.get('noise', states.noise)
    logL, misfits, valid, cache = sampler.ev.eval_cold(vs, z, n, vpvs,
                                                       noise, states.cell)
    return dataclasses.replace(states, vs=vs, z=z, n=n, logL=logL,
                               misfits=misfits, cache=cache,
                               **fields), valid


def dim_step(sampler, states, gen, birth):
    """One step of the dimension move with every chain's direction set:
    a birth (``birth`` True) or a death."""
    draws = sampler.draw(gen, states, chain.MOVE_DIM)
    draws['coin'] = torch.full_like(draws['coin'], bool(birth))
    return sampler.step(states, chain.MOVE_DIM, draws)


def _dim_counts(states):
    """(proposed, forward rejects) of the dimension moves, summed."""
    slot = chain.PARIDX[chain.MOVE_DIM]
    return (int(states.proposed[:, slot].sum()),
            int(states.fwdfail[:, slot].sum()))


def dim_reject_pin(sampler, C=PIN_CHAINS):
    """(g-1): the grown ensemble of ``C`` chains in ``sampler`` (of
    :func:`pin_sampler`; initial noise and vp/vs of
    ``init_states_host(0, C)``, as the pin takes them), two rounds of a
    birth then a death step; the forward-reject percentages of each
    direction and combined against ``PIN_BANDS``, ``ok`` only with every
    grown model valid in its cold evaluation and every proposal inside
    the prior, as the pin asserts."""
    states, gen = sampler.init_states_host(0, C)
    states, valid = _with_models(sampler, states, *grown_models(C,
                                                                sampler.nl))
    fails = {'birth': 0, 'death': 0}
    prev = 0
    for _ in range(2):
        for name in ('birth', 'death'):
            states = dim_step(sampler, states, gen, name == 'birth')
            f = _dim_counts(states)[1]
            fails[name] += f - prev
            prev = f
    proposed = _dim_counts(states)[0]
    out = dict(chains=C, proposed=proposed,
               cold_valid=int(valid.sum()),
               birth=100.0 * fails['birth'] / (2 * C),
               death=100.0 * fails['death'] / (2 * C),
               combined=100.0 * (fails['birth'] + fails['death']) / (4 * C))
    out['ok'] = out['cold_valid'] == C and proposed == 4 * C and all(
        lo <= out[k] <= hi for k, (lo, hi) in PIN_BANDS.items())
    return out


def tile_states(states, reps):
    """``states`` repeated ``reps`` times along the chain axis."""
    def tile(x):
        return x.repeat((reps,) + (1,) * (x.dim() - 1))
    out = {f.name: tile(getattr(states, f.name))
           for f in dataclasses.fields(states) if f.name != 'cache'}
    out['cache'] = tuple(tuple(tile(a) for a in c) for c in states.cache)
    return chain.ChainState(**out)


def converged_band(sampler):
    """(g-2): the converged snapshot's 21 chains (models, vp/vs, noise,
    adapted widths) in ``sampler`` (of :func:`pin_sampler`), evaluated
    cold once and tiled ``CONVERGED_REPS`` times, fresh randoms from the
    generator of ``init_states_host(0, 21)``; birth, death, birth,
    death at the tiled width; the dimension-reject rate against
    ``CONVERGED_BAND``."""
    with np.load(CONVERGED) as f:
        snap = {k: f[k] for k in ('vs', 'z', 'n', 'vpvs', 'noise',
                                  'propdist')}
    states, gen = sampler.init_states_host(0, snap['n'].shape[0])
    states, _ = _with_models(sampler, states, snap['vs'], snap['z'],
                             snap['n'], vpvs=snap['vpvs'],
                             noise=snap['noise'],
                             propdist=snap['propdist'])
    states = tile_states(states, CONVERGED_REPS)
    for birth in (True, False, True, False):
        states = dim_step(sampler, states, gen, birth)
    proposed, failed = _dim_counts(states)
    rate = 100.0 * failed / max(proposed, 1)
    lo, hi = CONVERGED_BAND
    return dict(chains=int(states.n.shape[0]), proposed=proposed,
                failed=failed, rate=rate, ok=lo < rate < hi)


# ----------------------------------------------------------------------
# (g-3): the warm walker against a float64 golden
# ----------------------------------------------------------------------

# tests/test_swd_sweep.py: the pathology models' slots, periods, kinds
WALK_NL = 10
WALK_PERIODS = np.linspace(2.0, 35.0, 11)
WALK_KINDS = ('plain', 'lvz', 'hvz', 'thin', 'vpvs')
WALK_MODELS = 6           # models per kind
WALK_SEED = 17


def _pad(arr, hs):
    out = np.full(WALK_NL, hs)
    out[:arr.size] = arr
    return out


def pathology_model(rs, kind):
    """``tests/test_swd_sweep.py`` ``make_model``: a random layered model
    (h, vp, vs, rho) of a pathology class (low- or high-velocity zone,
    a thin layer, high vp/vs) or a plain one."""
    nlay = rs.randint(3, 7)
    vs = np.sort(rs.uniform(2.2, 4.6, nlay))
    h = rs.uniform(3.0, 15.0, nlay)
    vpvs = 1.73
    if kind == 'lvz':
        i = rs.randint(1, nlay - 1)
        vs[i] = vs[i - 1] * rs.uniform(0.75, 0.95)
    elif kind == 'hvz':
        i = rs.randint(1, nlay - 1)
        vs[i] = min(vs[i + 1] * rs.uniform(1.05, 1.25), 4.8)
    elif kind == 'thin':
        h[rs.randint(0, nlay - 1)] = rs.uniform(0.3, 1.5)
    elif kind == 'vpvs':
        vpvs = rs.uniform(1.9, 2.1)
    h[-1] = 0.0
    vp = vs * vpvs
    rho = vp * 0.32 + 0.77
    return h, vp, vs, rho


def cold_golden(h, vp, vs, rho):
    """The port's float64 cold solve on the CPU of one unpadded model
    (Rayleigh phase velocity at ``WALK_PERIODS``): (cg (P,), err), the
    contract of ``bayhunter_tpu.native.surfdisp_native``."""
    lay = [torch.tensor(x, dtype=torch.float64)[None] for x in (h, vp, vs,
                                                                 rho)]
    cg, err, _, _ = swd.surfdisp_roots_cold(*lay, WALK_PERIODS, iwave=2)
    return cg[0].numpy(), bool(err[0])


def walker_cases(golden=cold_golden):
    """The JAX test's cases, kind by kind: ``WALK_MODELS`` pathology
    models each with one velocity moved by N(0, 0.015) (clipped to 2-5
    km/s), vp/vs kept, kept where ``golden`` of the perturbed model
    finds every period.  Returns [(rows0, rows2, gold)] per kind: the
    unperturbed and perturbed (n, 4, WALK_NL) padded layers (h, vp, vs,
    rho) and the (n, P) golden velocities."""
    rs = np.random.RandomState(WALK_SEED)
    out = []
    for kind in WALK_KINDS:
        rows0, rows2, golds = [], [], []
        while len(rows0) < WALK_MODELS:
            h, vp, vs, rho = pathology_model(rs, kind)
            vs2 = vs.copy()
            i = rs.randint(0, vs.size)
            vs2[i] = np.clip(vs2[i] + rs.normal(0, 0.015), 2.0, 5.0)
            vp2 = vs2 * (vp[0] / vs[0])
            rho2 = vp2 * 0.32 + 0.77
            cg, err = golden(h, vp2, vs2, rho2)
            if err:
                continue
            rows0.append([_pad(h, 0.0), _pad(vp, vp[-1]), _pad(vs, vs[-1]),
                          _pad(rho, rho[-1])])
            rows2.append([_pad(h, 0.0), _pad(vp2, vp2[-1]),
                          _pad(vs2, vs2[-1]), _pad(rho2, rho2[-1])])
            golds.append(cg)
        out.append((np.array(rows0), np.array(rows2), np.array(golds)))
    return out


def walker_operands(layers):
    """K2's model operands of (C, NL) layer tensors (h, vp, vs, rho):
    the (4 NL, C) planes [d; a; b; rho], cm, betmx and each chain's
    deepest layer, as K1 gives them."""
    props = torch.cat([x.T for x in layers]).contiguous()
    cm, bx = swd.lower_bound(layers[1], layers[2], dim=1)
    return props, cm, bx, swd.layer_top(layers[0]).to(torch.float32)


def warm_walk(rows0, rows2, device):
    """Float32 phase velocities (C, P) of the perturbed models ``rows2``
    warm-solved from the cold roots of ``rows0``, with the JAX test's
    warm settings (ring 2, a cap of 2 trips, one Newton pass, no
    bisection, no cached slope: ``swd.WARM_VS`` without its slope)."""
    def layers(rows):
        return [torch.tensor(rows[:, j].astype(np.float32), device=device)
                for j in range(4)]
    _, _, roots, _ = swd.surfdisp_roots_cold(*layers(rows0), WALK_PERIODS,
                                             iwave=2)
    props, cm, bx, top = walker_operands(layers(rows2))
    omegas = swd.angular_frequencies(WALK_PERIODS, props.device)
    c, found, _ = swd.warm_solve(props, cm, bx, top, omegas,
                                 roots.contiguous(), swd.WARM_VS,
                                 slope_prev=None, iwave=2)
    t, _ = swd.lane_periods(WALK_PERIODS, 0, props.device)
    cg, _ = swd.velocities(c, found, t, 0)
    return cg.cpu().numpy()


def walker_golden(device, golden=cold_golden):
    """(g-3): the warm walker's root error against ``golden`` over the
    found lanes: lanes, median, p99 (outliers excluded), root-selection
    outliers (error above 1.5e-3) and ``ok`` under ``WALKER_BOUNDS``."""
    errs = []
    n_outlier = 0
    for rows0, rows2, gold in walker_cases(golden):
        cg = warm_walk(rows0, rows2, device)
        found = np.isfinite(cg) & (cg > 0)
        e = np.abs(cg[found] - gold[found])
        n_outlier += int((e > WALKER_BOUNDS['outlier']).sum())
        errs.append(e[e <= WALKER_BOUNDS['outlier']])
    e = np.concatenate(errs)
    b = WALKER_BOUNDS
    out = dict(lanes=int(e.size), median=float(np.median(e)),
               p99=float(np.percentile(e, 99)), max=float(e.max()),
               outliers=n_outlier)
    out['ok'] = (e.size >= b['lanes'] and out['median'] < b['median']
                 and out['p99'] < b['p99']
                 and n_outlier <= b['outlier_share'] * (e.size + n_outlier))
    return out


# ----------------------------------------------------------------------
# (g-4): the prior-only layer histogram
# ----------------------------------------------------------------------

class FlatEval:
    """A constant likelihood on the evaluator's interface for
    ``ntargets`` targets; the prior validity is K1's
    (``prep.model_operands``, no RF target)."""

    def __init__(self, priors, ntargets=1):
        self.priors = priors
        self.ntargets = ntargets

    def _flat(self, C, device):
        return (torch.zeros(C, dtype=chain.DTYPE, device=device),
                torch.zeros((C, self.ntargets + 1), dtype=chain.DTYPE,
                            device=device),
                torch.ones(C, dtype=torch.bool, device=device))

    def eval_cold(self, vs, z, n, vpvs, noise, cell=None):
        logL, misfits, ok = self._flat(vs.shape[0], vs.device)
        return logL, misfits, ok, ((misfits[:, :1],),)

    def eval_full_batch_t(self, vs_t, z_t, n, vpvs, noise, cache, warm,
                          cell=None):
        mvalid, _, _ = prep.model_operands(vs_t, z_t, n, vpvs, self.priors,
                                           ())
        logL, misfits, ok = self._flat(n.shape[0], n.device)
        return logL, misfits, ok, cache, mvalid

    def eval_noise(self, noise, cache, cell=None):
        logL, _, ok = self._flat(noise.shape[0], noise.device)
        return logL, ok


def prior_sampler(priors, device, noiserefs=('swd',), nl=None):
    """The sampler of a prior-only run: ``priors`` (``nl`` layer slots,
    by default the prior's most layers + 1) under a constant likelihood
    (:class:`FlatEval`) for the targets' ``noiserefs``, the JAX test's
    prior-only widths (``PRIOR_INITPARAMS``)."""
    cfg = chain.make_config(priors, PRIOR_INITPARAMS, list(noiserefs),
                            nl=nl)
    mp = prep.ModelPriors(*priors['layers'], *priors['vs'], *priors['z'],
                          PRIOR_INITPARAMS['thickmin'], None, None)
    return chain.Sampler(FlatEval(mp, len(noiserefs)), cfg, device)


def prior_histogram(sampler, nchains, seed=7, segments=PRIOR_SEGMENTS,
                    drop=PRIOR_DROP):
    """(g-4): ``segments`` segments of ``PRIOR_SEGMENT`` late iterations
    of ``nchains`` prior-only chains through ``dispatch_cycles``, the
    nucleus counts after each segment past the first ``drop`` pooled.
    Returns the histogram over the prior's counts, its largest distance
    from uniform, two standard errors of a bin (``se_bound``: each
    chain's samples taken as one draw, the worst case of correlation
    within a chain; ``se_chains``: the spread of the chains' own
    histograms over sqrt(nchains)), the vs range of the last states,
    ``ok``: every bin within ``PRIOR_TOL`` of uniform and the vs inside
    the prior, and ``se_ok``: both standard errors under a third of
    ``PRIOR_TOL``, the condition for fewer kept segments than the JAX
    test's."""
    lo_n = sampler.cfg.layers_prior[0] + 1   # nuclei incl. halfspace
    hi_n = sampler.cfg.layers_prior[1] + 1
    bins = hi_n - lo_n + 1
    states, gen = sampler.init_states_host(seed, nchains)
    it = 0                                   # past early_cutoff: late
    per_chain = np.zeros((nchains, bins))
    for s in range(segments):
        states = chain.dispatch_cycles(sampler, states, it, PRIOR_SEGMENT,
                                       gen)
        it += PRIOR_SEGMENT
        if s >= drop:
            n = states.n.cpu().numpy().astype(np.int64)
            if n.min() < lo_n or n.max() > hi_n:
                raise AssertionError('nucleus count outside the prior')
            per_chain[np.arange(nchains), n - lo_n] += 1
    kept = segments - drop
    hist = per_chain.sum(0) / (kept * nchains)
    u = 1.0 / bins
    dev = float(np.abs(hist - u).max())
    se_bound = float(np.sqrt(u * (1 - u) / nchains))
    se_chains = float((per_chain / kept).std(0, ddof=1).max()
                      / np.sqrt(nchains))
    vs = states.vs.cpu().numpy()
    active = np.arange(sampler.nl)[None, :] < states.n.cpu().numpy()[:, None]
    vmin, vmax = float(vs[active].min()), float(vs[active].max())
    vs_lo, vs_hi = sampler.cfg.vs_prior
    return dict(chains=nchains, segments=segments, dropped=drop,
                samples=int(kept * nchains), hist=hist.tolist(),
                max_dev=dev, se_bound=se_bound, se_chains=se_chains,
                vs_range=(vmin, vmax),
                ok=dev < PRIOR_TOL and vmin >= vs_lo and vmax <= vs_hi,
                se_ok=max(se_bound, se_chains) < PRIOR_TOL / 3)


def check(name, result):
    """``result`` of the gate ``name``; raises unless it is ``ok``."""
    if not result['ok']:
        raise AssertionError('gate %s failed: %r' % (name, result))
    return result
