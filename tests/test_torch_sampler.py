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


def compare_cycle(late):
    """Run one cycle in both packages from the same grown states and
    compare them, adaptation of the proposal widths included."""
    from test_dim_reject_pin import _bench_config_sampler, _grown_states

    sj, ej = _bench_config_sampler()
    sp, _ = bench_config.build('cpu', iters=ITERS)
    order = sp.late_order if late else sp.early_order
    st = with_adaptation_points(_grown_states(sj, ej, C), len(order))
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
    np.testing.assert_allclose(ps.logL.numpy()[ok], np.asarray(js.logL)[ok],
                               rtol=1e-4)
    assert_roots_close(ps.cache[0][1].numpy()[ok],
                       np.asarray(js.cache[0][1])[ok])
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


def test_init_states_match_jax():
    if run_isolated('tests/test_torch_sampler.py::'
                    'test_init_states_match_jax'):
        return
    from test_dim_reject_pin import _bench_config_sampler
    sj, _ = _bench_config_sampler()
    js = sj.init_states_host(0, C)
    sp, _ = bench_config.build('cpu', iters=ITERS)
    ps, _ = sp.init_states_host(0, C)
    for f in ('vs', 'z', 'n', 'vpvs', 'noise'):
        assert np.array_equal(getattr(ps, f).numpy(),
                              np.asarray(getattr(js, f))), f
    np.testing.assert_allclose(ps.logL.numpy(), np.asarray(js.logL),
                               rtol=1e-4)
    assert_roots_close(ps.cache[0][1].numpy(), np.asarray(js.cache[0][1]))
    back = convert.state_to_numpy(ps)
    again = convert.state_from_numpy(back, 'cpu')
    for f in convert.FLOAT_FIELDS + convert.INT_FIELDS:
        assert torch.equal(getattr(again, f), getattr(ps, f)), f


def test_early_cycle_matches_jax():
    if run_isolated('tests/test_torch_sampler.py::'
                    'test_early_cycle_matches_jax'):
        return
    compare_cycle(late=False)
