"""The port's sampler vs the JAX package's on the bench configuration
(CPU, float32): initial states, and one early cycle (vs, z, noise) from
the grown posterior-like ensemble of tests/test_dim_reject_pin.py, with
counters and iteration numbers set so that every chain meets a
proposal-width adaptation point within the cycle.  The mixed cycle is
in test_torch_cycle.py.

The port takes its randoms as explicit per-chain ``draws``; here they
are computed from the JAX chains' PRNG keys exactly as the JAX moves
draw them (chain.py:654-823; a key advances by its first split
whether or not the move is accepted), so both samplers see the same
proposals.

The same comparisons on ``tutorial_rl_prf`` are in test_torch_rl_prf*.py
and on ``tutorial_prf_srf`` (Rayleigh + P-RF + S-RF) in
test_torch_prf_srf*.py.
"""

import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.dirname(__file__))

from conftest import run_isolated  # noqa: E402
from bayhunter_tpu_torch import bench_config, convert  # noqa: E402
from bayhunter_tpu_torch.sampler import chain as tchain  # noqa: E402
from test_pallas import (  # noqa: E402
    _assert_roots_close as assert_roots_close)

C = 12
ITERS = 4096          # iter_burnin of _bench_config_sampler


def jax_draws(keys, n, move, zmin, zmax, nnoise):
    """(next keys, port draws) of one JAX step of ``move``."""
    f32 = jnp.float32
    if move == tchain.MOVE_DIM:
        ks = jax.vmap(lambda k: random.split(k, 5))(keys)
        key, k1, k2, kc, ku = (ks[:, i] for i in range(5))
        d = dict(coin=jax.vmap(random.bernoulli)(kc),
                 uniform=jax.vmap(lambda k: random.uniform(
                     k, (), f32, zmin, zmax))(k1))
    else:
        ks = jax.vmap(lambda k: random.split(k, 4))(keys)
        key, k1, k2, ku = (ks[:, i] for i in range(4))
        d = {}
    hi = jnp.full(n.shape, nnoise) if move == tchain.MOVE_NOISE \
        else jnp.asarray(n)
    d['index'] = jax.vmap(lambda k, m: random.randint(k, (), 0, m))(k1, hi)
    d['normal'] = jax.vmap(lambda k: random.normal(k, dtype=f32))(k2)
    d['logu'] = jnp.log(jax.vmap(
        lambda k: random.uniform(k, dtype=f32))(ku))
    out = {}
    for name, v in d.items():
        v = np.asarray(v)
        out[name] = torch.tensor(v.astype(np.int64) if name == 'index'
                                 else v)
    return key, out


def with_adaptation_points(st, nsteps):
    """``st`` with counters and iteration numbers that make the cycle
    adapt the proposal widths: chain i reaches iiter = 0 (mod 1000) at
    step i % nsteps, every active slot already proposed 100 times with
    acceptance rates of 20, 42 or 60 % — below, inside and above the
    (40, 45) % band, far enough that one step cannot move a rate across
    an edge.  Chains 0 and 6 start their vs width just above the 0.001
    floor with a rate below the band, so the floor clips them; chain 1
    has not proposed a dimension move yet, so its gate stays shut."""
    i = np.arange(C)[:, None]
    slot = np.arange(5)[None, :]
    proposed = np.where(slot < 4, 100, 0).astype(np.int32)
    proposed = np.broadcast_to(proposed, (C, 5)).copy()
    accepted = np.choose((i + slot) % 3, [20, 42, 60]).astype(np.int32)
    accepted[:, 4] = 0
    proposed[1, 2] = accepted[1, 2] = 0
    pd = np.array(st.propdist)
    pd[[0, 6], 0] = 0.00102
    iiter = (-3000 - np.arange(C) % nsteps).astype(np.int32)
    return st._replace(
        iiter=jnp.asarray(iiter, st.iiter.dtype),
        accepted=jnp.asarray(accepted, st.accepted.dtype),
        proposed=jnp.asarray(proposed, st.proposed.dtype),
        propdist=jnp.asarray(pd, st.propdist.dtype))


def samplers(config='tutorial', nl=21):
    """(JAX sampler, JAX evaluator, port sampler) of the configuration
    ``config`` of ``bench_config.CONFIGS``; the JAX one on the batch
    path with the Pallas kernels in interpret mode."""
    from test_dim_reject_pin import _bench_config_sampler
    if config == 'tutorial':
        sj, ej = _bench_config_sampler(nl)
        return sj, ej, bench_config.build('cpu', iters=ITERS, nl=nl)[0]
    from bayhunter_tpu import Targets
    from bayhunter_tpu.sampler.chain import build_sampler, make_config
    from bayhunter_tpu.sampler.evaluator import build_evaluator
    refs = bench_config.CONFIGS[config]
    targets = []
    for ref in refs:
        obs = np.loadtxt(os.path.join(bench_config.FIXTURES,
                                      'st3_%s.dat' % ref))
        cls = getattr(Targets, bench_config.TARGETS[ref].__name__)
        targets.append(cls(obs[:, 0], obs[:, 1]))
    joint = Targets.JointTarget(targets=targets)
    ip = bench_config.initparams(ITERS)
    cfg = make_config(bench_config.PRIORS, ip,
                      [t.noiseref for t in targets], nl=nl)
    ej = build_evaluator(joint, bench_config.PRIORS, ip, nl,
                         use_batch_swd=True, interpret=True)
    return (build_sampler(ej, cfg), ej,
            bench_config.build_config(config, 'cpu', iters=ITERS, nl=nl)[0])


def wide_noise(noise, sp, seed=4):
    """``noise`` with its sigmas drawn from the upper part of their
    priors (SWD 0.02-0.04 km/s, RF 0.01-0.018)."""
    rs = np.random.RandomState(seed)
    noise = np.array(noise)
    for t, spec in enumerate(sp.ev.specs):
        lo, hi = (0.02, 0.04) if spec.kind == 'swd' else (0.01, 0.018)
        noise[:, 2 * t + 1] = rs.uniform(lo, hi, noise.shape[0])
    return noise


def with_wide_noise(st, ej, sp, seed=4):
    """``st`` with :func:`wide_noise` sigmas and logL re-scored.  The
    grown states fit the Love data and the RF less well than the
    Rayleigh data, and at the sigmas of the init draws (down to 0.002)
    the f32 rounding of the synthetics, common to both packages (the RF
    is 2.5e-5 from a float64 evaluation in either), moves logL by ~1,
    enough to tip accept decisions 0.1 from their threshold."""
    noise = jnp.asarray(wide_noise(st.noise, sp, seed), st.noise.dtype)
    logL = jax.vmap(lambda no, ca: ej.eval_noise(no, ca)[0])(noise,
                                                            st.cache)
    return st._replace(noise=noise, logL=jnp.asarray(logL, st.logL.dtype))


def target_terms(sp, cache, noise):
    """(T, C) per-target log-likelihood terms of a state's cached
    synthetics under the port's laws."""
    noise = torch.tensor(np.asarray(noise, np.float32))
    return np.stack([
        spec.loglike(torch.tensor(np.asarray(cache[t][0], np.float32))
                     - spec.yobs, noise[:, 2 * t + 1]).numpy()
        for t, spec in enumerate(sp.ev.specs)])


def compare_cycle(late, config='tutorial', nl=21):
    """Run one cycle in both packages from the same grown states and
    compare them, adaptation of the proposal widths included."""
    from test_dim_reject_pin import _grown_states

    sj, ej, sp = samplers(config, nl)
    order = sp.late_order if late else sp.early_order
    st = _grown_states(sj, ej, C, nl=nl)
    three = len(sp.ev.specs) == 3
    if three:
        st = with_wide_noise(st, ej, sp)
    st = with_adaptation_points(st, len(order))
    marginal = []
    log_alpha = sp.log_alpha

    def recording(states, prop, logL_p):
        alpha = log_alpha(states, prop, logL_p)
        marginal.append((prop['logu'] - alpha).abs() < 1e-3)
        return alpha

    sp.log_alpha = recording
    ps0 = ps = convert.state_from_numpy(st, 'cpu')
    keys = st.key
    zmin, zmax = sp.cfg.z_prior
    for move in order:
        keys, draws = jax_draws(keys, ps.n.numpy(), move, zmin, zmax,
                                len(sp.cfg.noiseinds))
        ps = sp.step(ps, move, draws)
    cycle = sj.cycle_mixed_fn if late else sj.cycle_early_fn
    js = cycle(jax.tree.map(jnp.copy, st))

    near = torch.stack(marginal).any(dim=0).numpy()
    assert near.sum() <= 1, near.sum()
    ok = ~near
    for f in ('n', 'accepted', 'proposed', 'fwdfail', 'iiter'):
        assert np.array_equal(getattr(ps, f).numpy()[ok],
                              np.asarray(getattr(js, f))[ok]), f
    for f in ('vs', 'z'):
        np.testing.assert_allclose(getattr(ps, f).numpy()[ok],
                                   np.asarray(getattr(js, f))[ok], rtol=0,
                                   atol=1e-6)
    # each target's log-likelihood term of the cached synthetics, held
    # to 1e-4 of the terms' total magnitude: a term is itself a sum of
    # parts of opposite sign (-n log sigma and -chi^2 / 2)
    terms = target_terms(sp, ps.cache, ps.noise)
    scale = 1e-4 * np.abs(terms).sum(axis=0)[ok]
    d = np.abs(terms - target_terms(sp, js.cache, js.noise))[:, ok]
    assert np.all(d <= scale), (d / scale).max()
    logL, logL_j = ps.logL.numpy()[ok], np.asarray(js.logL)[ok]
    if three:
        # with three targets, terms of opposite sign can cancel to a
        # total near 0 (6.9 from -67, -2290 and +2365 in one chain), so
        # the total is held to the same scale as its terms
        d = np.abs(logL - logL_j)
        assert np.all(d <= scale + 1e-4 * np.abs(logL_j)), d.max()
    else:
        np.testing.assert_allclose(logL, logL_j, rtol=1e-4)
    for t, spec in enumerate(sp.ev.specs):
        if spec.kind == 'swd':
            assert_roots_close(ps.cache[t][1].numpy()[ok],
                               np.asarray(js.cache[t][1])[ok])
    accepted = (ps.accepted - ps0.accepted).numpy().sum(axis=0)
    assert accepted[0] > 0 and accepted[1] > 0
    if late:
        assert accepted[2] > 0
    # adaptation: the rates sit far from the band edges, so every chain
    # adapts alike in both packages, marginal accepts included
    pd = ps.propdist.numpy()
    assert np.array_equal(pd, np.asarray(js.propdist, np.float32))
    changed = (pd != ps0.propdist.numpy()).any(axis=1)
    assert changed.sum() == C - 1 and not changed[1]
    assert pd[0, 0] == pd[6, 0] == np.float32(0.001)
    return ps, js


def compare_init(config='tutorial', nl=21, chains=C, terms=False):
    """Initial states of ``chains`` chains in both packages from one
    seed; returns the port's.  The total logL is held to rtol 1e-4, or
    with ``terms`` each target's log-likelihood term to 1e-4 of the
    terms' magnitude at :func:`wide_noise` sigmas and the RF synthetics
    to the JAX package's own Pallas-vs-XLA bound (5e-5,
    tests/test_pallas.py:335): the cold synthetics of both packages
    carry f32 rounding of up to 3e-5, which the whitened Gaussian law
    amplifies at the smallest init sigmas (0.007 and below) to 1.3e-4
    of the terms of two RF targets."""
    sj, _, sp = samplers(config, nl)
    js = sj.init_states_host(0, chains)
    ps, _ = sp.init_states_host(0, chains)
    for f in ('vs', 'z', 'n', 'vpvs', 'noise'):
        assert np.array_equal(getattr(ps, f).numpy(),
                              np.asarray(getattr(js, f))), f
    if terms:
        noise = wide_noise(js.noise, sp)
        tj = target_terms(sp, js.cache, noise)
        d = np.abs(target_terms(sp, ps.cache, noise) - tj)
        assert np.all(d <= 1e-4 * np.abs(tj).sum(axis=0)), d.max()
        for t, spec in enumerate(sp.ev.specs):
            if spec.kind == 'rf':
                np.testing.assert_allclose(ps.cache[t][0].numpy(),
                                           np.asarray(js.cache[t][0]),
                                           rtol=0, atol=5e-5)
    else:
        np.testing.assert_allclose(ps.logL.numpy(), np.asarray(js.logL),
                                   rtol=1e-4)
    for t, spec in enumerate(sp.ev.specs):
        if spec.kind == 'swd':
            found = np.asarray(js.cache[t][2]) != 0.0
            assert np.array_equal(ps.cache[t][2].numpy() != 0.0, found)
            assert_roots_close(ps.cache[t][1].numpy()[found],
                               np.asarray(js.cache[t][1])[found])
    return ps


def test_init_states_match_jax():
    if run_isolated('tests/test_torch_sampler.py::'
                    'test_init_states_match_jax'):
        return
    ps = compare_init()
    back = convert.state_to_numpy(ps)
    again = convert.state_from_numpy(back, 'cpu')
    for f in convert.FLOAT_FIELDS + convert.INT_FIELDS:
        assert torch.equal(getattr(again, f), getattr(ps, f)), f


def test_early_cycle_matches_jax():
    if run_isolated('tests/test_torch_sampler.py::'
                    'test_early_cycle_matches_jax'):
        return
    compare_cycle(late=False)


# ----------------------------------------------------------------------
# the remainder of dispatch_cycles: the JAX package's random-scan
# schedule (bayhunter_tpu/sampler/chain.py _move_for :1137-1144, used by
# its dispatch_cycles for a remainder shorter than a cycle :1520-1526):
# each iteration's move uniform over the move list of its own phase,
# early_moves = (vs, z, noise), late_moves = (vs, z, birth, death, noise)
# (:296-300); the port's MOVE_DIM draws birth or death per chain, so it
# carries weight 2/5 late.
JAX_EARLY = {tchain.MOVE_VS: 1 / 3, tchain.MOVE_Z: 1 / 3,
             tchain.MOVE_NOISE: 1 / 3}
JAX_LATE = {tchain.MOVE_VS: 0.2, tchain.MOVE_Z: 0.2, tchain.MOVE_DIM: 0.4,
            tchain.MOVE_NOISE: 0.2}
# chi-square quantiles at p = 0.001 for 2 and 3 degrees of freedom
CHI2_999 = {2: 13.816, 3: 16.266}


def _chi2(moves, weights):
    moves = np.asarray(moves)
    assert set(moves) <= set(weights)
    n = len(moves)
    return sum((np.sum(moves == m) - n * p) ** 2 / (n * p)
               for m, p in weights.items())


class _Recorder:
    """A sampler's move lists and early cutoff, recording the moves its
    cycles and steps run."""

    def __init__(self, sp):
        self.early_order, self.late_order = sp.early_order, sp.late_order
        self.early_cutoff = sp.early_cutoff
        self.ran = []

    def draw(self, gen, states, move):
        return None

    def step(self, states, move, draws):
        self.ran.append(move)
        return states

    def cycle(self, states, order, gen):
        for move in order:
            states = self.step(states, move, None)
        return states


def test_remainder_moves_follow_the_random_scan_weights():
    sp = bench_config.build('cpu', iters=ITERS)[0]
    assert sp.early_order == [tchain.MOVE_VS, tchain.MOVE_Z,
                              tchain.MOVE_NOISE]
    assert sp.late_order == [tchain.MOVE_VS, tchain.MOVE_Z, tchain.MOVE_DIM,
                             tchain.MOVE_DIM, tchain.MOVE_NOISE]
    gen = torch.Generator().manual_seed(5)
    early = sum((tchain.remainder_moves(sp, -ITERS, 2, gen)
                 for _ in range(6000)), [])
    late = sum((tchain.remainder_moves(sp, 0, 4, gen)
                for _ in range(5000)), [])
    assert _chi2(early, JAX_EARLY) < CHI2_999[2]
    assert _chi2(late, JAX_LATE) < CHI2_999[3]


def test_remainder_switches_lists_at_the_early_cutoff():
    sp = bench_config.build('cpu', iters=ITERS)[0]
    first_late = int(np.ceil(sp.early_cutoff))
    it0 = first_late - 2
    gen = torch.Generator().manual_seed(9)
    draws = np.array([tchain.remainder_moves(sp, it0, 4, gen)
                      for _ in range(4000)])
    assert _chi2(draws[:, :2].ravel(), JAX_EARLY) < CHI2_999[2]
    assert _chi2(draws[:, 2:].ravel(), JAX_LATE) < CHI2_999[3]
    # dispatch_cycles: one whole early cycle, then a remainder shorter
    # than the early cycle that straddles the cutoff, on the schedule of
    # the same uniforms
    last = []
    for seed in range(20):
        rec = _Recorder(sp)
        start = first_late - 1 - len(sp.early_order)
        tchain.dispatch_cycles(rec, None, start, len(sp.early_order) + 2,
                               torch.Generator().manual_seed(seed))
        want = tchain.remainder_moves(sp, first_late - 1, 2,
                                      torch.Generator().manual_seed(seed))
        assert rec.ran == sp.early_order + want
        assert rec.ran[-2] in sp.early_order
        last.append(rec.ran[-1])
    assert tchain.MOVE_DIM in last
