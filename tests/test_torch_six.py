"""The slice as a whole: one z step and one vs step of ``tutorial_six``
(the six target kinds of the reference in one joint: Rayleigh and Love
phase and group velocity, P- and S-RF; ``bench_config.build_six``) from
grown states, with the JAX chains' randoms injected, against the JAX
``step_fn(states, move)`` on its batch path (``use_batch_swd``, the
Pallas kernels in interpret mode: the model kernel, the walker with
2P lanes and 12 bisections for the group targets, the RF response),
as ``tests/test_torch_sampler.py`` builds it, NL = 8, 10 chains, in a
fresh interpreter (``conftest.run_isolated``).  (The JAX CPU
optimizer's XLA path walks an uncapped ring; its warm solve finds
Love roots that the capped walk of the production path, and the
port's, reject.)

Held as the cycle tests hold a step (``tests/test_torch_sampler.py``
``compare_cycle``): accept decisions, counters and models equal on the
chains whose decision is not within 1e-3 of its threshold; each
target's log-likelihood term and the total within 1e-4 of the summed
magnitudes of the terms' parts; the dispersion roots at the phase-root
tolerance (p90 2e-5, max 5e-4) — the group targets' roots are the 2P
lanes of their two phase solves.
"""

import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from conftest import run_isolated  # noqa: E402

NL = 8
C = 10


def _targets():
    """(port, JAX) joint targets of the six fixtures."""
    from bayhunter_tpu import Targets as jtargets
    from bayhunter_tpu_torch import Targets, bench_config
    port, jax_side = [], []
    for ref in bench_config.SIX:
        obs = np.loadtxt(os.path.join(bench_config.FIXTURES,
                                      'st3_%s.dat' % ref))
        cls = bench_config.TARGETS[ref]
        port.append(cls(obs[:, 0], obs[:, 1]))
        jax_side.append(getattr(jtargets, cls.__name__)(obs[:, 0],
                                                        obs[:, 1]))
    return (Targets.JointTarget(port),
            jtargets.JointTarget(targets=jax_side))


def test_six_target_steps_match_jax():
    if run_isolated('tests/test_torch_six.py::'
                    'test_six_target_steps_match_jax'):
        return
    from bayhunter_tpu.sampler import chain as jchain
    from bayhunter_tpu.sampler import evaluator as jev
    from bayhunter_tpu_torch import bench_config, convert
    from bayhunter_tpu_torch.sampler import chain as tchain
    from bayhunter_tpu_torch.sampler import evaluator as tev
    from test_torch_sampler import assert_roots_close, jax_draws, wide_noise
    from test_torch_vpvs import _grown, _terms

    port_joint, jax_joint = _targets()
    priors = dict(bench_config.PRIORS, layers=(1, NL - 1))
    ip = bench_config.initparams(4096)
    noiserefs = [t.noiseref for t in port_joint.targets]
    ev = tev.build_evaluator(port_joint, priors, ip, NL, 'cpu')
    sp = tchain.Sampler(ev, tchain.make_config(priors, ip, noiserefs,
                                               nl=NL), 'cpu')
    assert [(s.kind, getattr(s, 'igr', None)) for s in ev.specs] == [
        ('swd', 0), ('swd', 1), ('swd', 0), ('swd', 1), ('rf', None),
        ('rf', None)]
    ej = jev.build_evaluator(jax_joint, priors, ip, NL, use_batch_swd=True,
                             interpret=True)
    sj = jchain.build_sampler(ej, jchain.make_config(priors, ip, noiserefs,
                                                     nl=NL))

    # grown states, cold-evaluated by the port, with the cycle tests'
    # sigmas; the group targets' cached roots are 2P lanes
    ps, _ = sp.init_states_host(0, C)
    VS, Z, N = _grown(C, NL)
    vpvs = np.full(C, 1.73, np.float32)
    noise = wide_noise(ps.noise.numpy(), sp).astype(np.float32)
    st = convert.state_to_numpy(ps)
    st.update(vs=VS, z=Z, n=N, vpvs=vpvs, noise=noise,
              iiter=np.full(C, -3001, np.int32))
    logL, misfits, valid, cache = ev.eval_cold(
        torch.tensor(VS), torch.tensor(Z), torch.tensor(N),
        torch.tensor(vpvs), torch.tensor(noise))
    assert bool(valid.all())
    assert [tuple(c[1].shape) for c in cache[:4]] == [
        (C, 21), (C, 42), (C, 21), (C, 42)]
    st.update(logL=logL.numpy(), misfits=misfits.numpy(),
              cache=tuple(tuple(a.numpy() for a in e) for e in cache))
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    js0 = jchain.ChainState(
        key=keys, **{f: jnp.asarray(st[f]) for f in (
            'vs', 'z', 'n', 'vpvs', 'noise', 'logL', 'misfits', 'propdist',
            'accepted', 'proposed', 'iiter', 'fwdfail', 'beta')},
        cache=tuple(tuple(jnp.asarray(a) for a in e) for e in st['cache']),
        cell=jnp.zeros(C, jnp.int32), swap_accepted=jnp.zeros(C, jnp.int32),
        swap_proposed=jnp.zeros(C, jnp.int32))

    marginal = []
    log_alpha = sp.log_alpha

    def recording(states, prop, logL_p):
        alpha = log_alpha(states, prop, logL_p)
        marginal.append(((prop['logu'] - alpha).abs() < 1e-3).numpy())
        return alpha

    sp.log_alpha = recording
    zmin, zmax = sp.cfg.z_prior
    accepted = 0
    for move in (tchain.MOVE_Z, tchain.MOVE_VS):
        ps0 = convert.state_from_numpy(st, 'cpu')
        _, draws = jax_draws(keys, N, move, zmin, zmax, 12)
        pt = sp.step(ps0, move, draws)
        jt = sj.step_fn(jax.tree.map(jnp.copy, js0), move)
        ok = ~marginal[-1]
        assert ok.sum() >= C - 1
        for f in ('n', 'accepted', 'proposed', 'fwdfail', 'iiter'):
            assert np.array_equal(getattr(pt, f).numpy()[ok],
                                  np.asarray(getattr(jt, f))[ok]), f
        for f in ('vs', 'z'):
            np.testing.assert_allclose(getattr(pt, f).numpy()[ok],
                                       np.asarray(getattr(jt, f))[ok],
                                       rtol=0, atol=1e-6)
        terms, parts = _terms(ev, pt.cache, pt.noise)
        scale = 1e-4 * parts.sum(axis=0)[ok]
        d = np.abs(terms - _terms(ev, jt.cache, jt.noise)[0])[:, ok]
        assert np.all(d <= scale), (d / scale).max()
        d = np.abs(pt.logL.numpy() - np.asarray(jt.logL))[ok]
        assert np.all(d <= scale), (d / scale).max()
        for t in range(4):
            assert_roots_close(pt.cache[t][1].numpy()[ok],
                               np.asarray(jt.cache[t][1])[ok])
        accepted += int((pt.accepted - ps0.accepted).sum())
        assert 0 < int((pt.proposed - ps0.proposed).sum()) <= C
    assert accepted > 0
