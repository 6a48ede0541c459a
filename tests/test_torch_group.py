"""Group velocity, higher modes, more than 60 periods and a fixed
rotation velocity: the port against the JAX package (CPU, float32).

  * the cold group solve (``swd.surfdisp_roots_cold`` with ``igr``: the
    2P lanes t / (1 +- HGR), three refinement passes) against the JAX
    ``surfdisp_roots``, Rayleigh and Love: the lane roots at the
    phase-root tolerance of ``tests/test_torch_love.py`` (p90 2e-5, max
    5e-4), the group velocities at the golden tolerances of
    ``tests/test_swd.py:35-36`` (5e-4 Rayleigh, 1e-3 Love);
  * mode 2 (``tests/test_swd.py:131-132``'s model and periods, and the
    ensemble) at the phase-root tolerance;
  * K2's group arm — the walker twin with 2P lanes and 12 bisections —
    against ``pallas_walk.warm_roots_walk`` in interpret mode, one case
    per move class, at the phase-root tolerance;
  * an 81-period Rayleigh target through the evaluator: the synthetics
    solved at 60 periods and interpolated (``swd.interp``) against the
    JAX evaluator's, at the phase-root tolerance;
  * a P-RF target with a fixed ``nsv`` through the evaluator against
    the JAX evaluator, at the JAX package's Pallas-vs-XLA RF bound
    (5e-5, ``tests/test_pallas.py:335``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu.ops import swd as jswd  # noqa: E402
from bayhunter_tpu.ops.pallas_walk import warm_roots_walk  # noqa: E402
from bayhunter_tpu_torch import Targets, bench_config  # noqa: E402
from bayhunter_tpu_torch.ops import prep, swd, walk  # noqa: E402
from bayhunter_tpu_torch.sampler import evaluator as tev  # noqa: E402
from test_pallas import _assert_roots_close  # noqa: E402
from test_torch_kernels import CFGT, NL, _ensemble, _t  # noqa: E402

PERIODS = np.linspace(1, 41, 21).astype(np.float32)
GROUP_TOLS = {2: 5e-4, 1: 1e-3}


def _operands():
    """The port's K1 operands (the twin, within 3e-6 of the JAX kernel,
    tests/test_torch_kernels.py) of the default ensemble: the flat
    walker planes, cm, betmx and top."""
    _, (props, cm, bx, top), _ = prep.model_operands(
        *(_t(x) for x in _ensemble()), prep.ModelPriors(*CFGT), ())
    return props, cm, bx, top


def _layers(props):
    return tuple(props[k * NL:(k + 1) * NL].T.contiguous() for k in range(4))


def _jax_roots(layers, periods, **kw):
    fn = jax.vmap(lambda h, a, b, r: jswd.surfdisp_roots(
        h, a, b, r, jnp.asarray(periods), return_slopes=True, **kw))
    return tuple(np.asarray(x) for x in fn(*(jnp.asarray(x.numpy())
                                              for x in layers)))


@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
def test_group_cold_solve_matches_jax(iwave):
    layers = _layers(_operands()[0])
    cg, err, roots, slopes = swd.surfdisp_roots_cold(*layers, PERIODS,
                                                     iwave, igr=1)
    assert roots.shape == (16, 42)
    cj, ej, rj, sj = _jax_roots(layers, PERIODS, iwave=iwave, igr=1)
    found = slopes.numpy() != 0.0
    assert np.array_equal(found, sj != 0.0)
    assert found.mean() > 0.8
    _assert_roots_close(roots.numpy()[found], rj[found])
    ok = ~err.numpy()
    assert np.array_equal(ok, ~ej) and ok.sum() >= 12
    np.testing.assert_allclose(cg.numpy()[ok], cj[ok], rtol=0,
                               atol=GROUP_TOLS[iwave])
    # the lanes are the two phase solves t / (1 +- 0.005), differenced
    t = torch.tensor(PERIODS)
    gv, both = swd.group_velocity(roots, slopes != 0.0, t)
    assert torch.equal(gv[torch.tensor(ok)], cg[torch.tensor(ok)])
    assert np.all((cg.numpy()[ok] < roots.numpy()[ok, :21] + 1e-3))


def test_higher_mode_matches_jax():
    # the tutorial model (tests/test_swd.py:131-132) as chain 0, padded
    # to the ensemble's slots
    periods = np.linspace(1, 10, 10).astype(np.float32)
    layers = [x.clone() for x in _layers(_operands()[0])]
    for x, v in zip(layers, ([5., 23., 8.] + [0.] * (NL - 3),
                             None, [2.7, 3.6, 3.8] + [4.4] * (NL - 3),
                             None)):
        if v is not None:
            x[0] = torch.tensor(v)
    layers[1][0] = layers[2][0] * 1.73
    layers[3][0] = layers[1][0] * 0.32 + 0.77
    c2, e2 = swd.surfdisp_batch(*layers, periods, mode=2, device='cpu')
    c1, _ = swd.surfdisp_batch(*layers, periods, device='cpu')
    cj, ej, _, _ = _jax_roots(layers, periods, mode=2)
    valid = c2.numpy() > 0
    assert np.array_equal(valid, cj > 0) and valid[0].any()
    assert np.array_equal(e2.numpy(), ej)
    _assert_roots_close(c2.numpy()[valid], cj[valid])
    assert np.all(c2.numpy()[valid] > c1.numpy()[valid])


@pytest.mark.parametrize('move', ['vs', 'z', 'dim'])
def test_group_walker_twin_matches_jax(move):
    st = {'vs': swd.WARM_VS, 'z': swd.WARM_Z, 'dim': swd.WARM_DIM}[move]
    props, cm, bx, top = _operands()
    layers = _layers(props)
    _, err, roots, slopes = swd.surfdisp_roots_cold(*layers, PERIODS, 2,
                                                    igr=1)
    assert not bool(err.any())
    rs = np.random.RandomState(5)
    cp = (roots.numpy() + 0.0013
          + rs.uniform(-0.004, 0.004, roots.shape)).astype(np.float32)
    om = swd.lane_frequencies(PERIODS, 1, 'cpu')
    sl = slopes.numpy() if st['cached_slope'] else None
    kw = dict(nbisect=swd.GROUP_NBISECT, newton_iters=st['newton_iters'],
              newton_maxshift=swd.NEWTON_MAXSHIFT)
    C = cp.shape[0]
    cj, fj, _ = warm_roots_walk(
        None, None, None, None, jnp.broadcast_to(jnp.asarray(om.numpy()),
                                                 (C, 42)),
        jnp.asarray(cp), jnp.asarray(cm.numpy())[:, None],
        jnp.asarray(bx.numpy())[:, None], swd.DDC, iwave=2,
        ring_k=st['ring'], trips=swd.WARM_CAP,
        slope_prev=None if sl is None else jnp.asarray(sl), layout_t=True,
        pstack=jnp.asarray(props.numpy()), top_chain=jnp.asarray(
            top.numpy()), interpret=True, **kw)
    ct, ft, stp = swd.warm_solve(props, cm, bx, top, om, _t(cp), st,
                                 slope_prev=None if sl is None else _t(sl),
                                 group=True)
    fj = np.asarray(fj)
    assert np.array_equal(ft.numpy(), fj) and fj.mean() > 0.95
    _assert_roots_close(ct.numpy()[fj], np.asarray(cj)[fj])
    assert np.array_equal(stp.numpy() == 0.0, ~fj)
    # the 12 bisections: a phase setting's walk would stop short of the
    # group solve's bracket
    cs, _, _ = walk.warm_roots_walk(
        props, om, _t(cp), cm, bx, top, st['ring'], swd.WARM_CAP,
        st['nbisect'], st['newton_iters'], swd.NEWTON_MAXSHIFT,
        slope_prev=None if sl is None else _t(sl))
    if st['nbisect'] < swd.GROUP_NBISECT and move == 'z':
        assert not torch.equal(cs, ct)


def _evaluators(targets, jax_targets, priors=bench_config.PRIORS):
    from bayhunter_tpu.sampler.evaluator import build_evaluator
    ip = bench_config.initparams(100)
    ev = tev.build_evaluator(Targets.JointTarget(targets), priors, ip, NL,
                             'cpu')
    from bayhunter_tpu import Targets as jtargets
    ej = build_evaluator(jtargets.JointTarget(targets=jax_targets), priors,
                         ip, NL)
    return ev, ej


def _cold(ev, ej):
    vs_t, z_t, n, vpvs = _ensemble()
    C = n.shape[0]
    noise = np.tile(np.array([[0.0, 0.02]], np.float32), (C, 1))
    out = ev.eval_cold(_t(vs_t.T.copy()), _t(z_t.T.copy()), _t(n),
                       _t(vpvs), _t(noise))
    jout = jax.vmap(ej.eval_cold)(*(jnp.asarray(x) for x in (
        vs_t.T.copy(), z_t.T.copy(), n, vpvs, noise)))
    return out, jout


def test_more_than_60_periods_matches_jax():
    from bayhunter_tpu import Targets as jtargets
    gold = np.loadtxt(os.path.join(bench_config.FIXTURES,
                                   'st3_rdispph.dat'))
    x = np.linspace(1, 41, 81)
    y = np.interp(x, gold[:, 0], gold[:, 1])
    ev, ej = _evaluators([Targets.RayleighDispersionPhase(x, y)],
                         [jtargets.RayleighDispersionPhase(x, y)])
    spec = ev.specs[0]
    assert spec.interp_x is not None and spec.periods.size == 60
    (logL, _, valid, cache), jout = _cold(ev, ej)
    y_t, roots = cache[0][0].numpy(), cache[0][1].numpy()
    yj, rj = np.asarray(jout[3][0][0]), np.asarray(jout[3][0][1])
    assert y_t.shape == yj.shape == (16, 81) and roots.shape == (16, 60)
    ok = valid.numpy()
    assert np.array_equal(ok, np.asarray(jout[2])) and ok.all()
    _assert_roots_close(roots, rj)
    _assert_roots_close(y_t, yj)
    # the interpolation holds the solved values at the solved periods
    np.testing.assert_allclose(y_t[:, [0, -1]], roots[:, [0, -1]], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(logL.numpy(), np.asarray(jout[0]),
                               rtol=1e-4)


def test_interp_matches_jnp_interp():
    rs = np.random.RandomState(3)
    xp = np.sort(rs.uniform(1, 40, 60)).astype(np.float32)
    xp[7] = xp[6]                                  # a zero-width step
    fp = rs.uniform(2, 4, (5, 60)).astype(np.float32)
    x = np.linspace(0, 45, 97).astype(np.float32)
    got = swd.interp(_t(x), _t(xp), _t(fp)).numpy()
    want = np.stack([np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                           jnp.asarray(f))) for f in fp])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fixed_nsv_matches_jax():
    from bayhunter_tpu import Targets as jtargets
    obs = np.loadtxt(os.path.join(bench_config.FIXTURES, 'st3_prf.dat'))
    port = Targets.PReceiverFunction(obs[:, 0], obs[:, 1])
    jt = jtargets.PReceiverFunction(obs[:, 0], obs[:, 1])
    for t in (port, jt):
        t.moddata.plugin.set_modelparams(nsv=3.1)
    ev, ej = _evaluators([port], [jt])
    assert ev.specs[0].nsv == 3.1
    (_, _, valid, cache), jout = _cold(ev, ej)
    assert bool(valid.all())
    np.testing.assert_allclose(cache[0][0].numpy(),
                               np.asarray(jout[3][0][0]), rtol=0, atol=5e-5)
    # the rotation velocity is in effect: the top layer's differs
    port.moddata.plugin.set_modelparams(nsv=None)
    ev0, _ = _evaluators([port], [jt])
    (_, _, _, cache0), _ = _cold(ev0, ej)
    assert float((cache0[0][0] - cache[0][0]).abs().max()) > 1e-3


def test_custom_target_is_not_ported():
    target = Targets.SingleTarget(np.arange(4.0), np.zeros(4), 'mine')
    target.noiseref = 'swd'
    with pytest.raises(NotImplementedError, match='run_model_jax'):
        tev.build_evaluator(Targets.JointTarget([target]),
                            bench_config.PRIORS, bench_config.initparams(
                                10), NL, 'cpu')
