"""A custom target (the plugin's forward hook) in the port's evaluator
and sampler against the JAX package's, float32 on the CPU.

The forward, the vertical S travel time from the surface to each
observed depth, is written once in PyTorch (``run_model_torch``,
batched over chains, as the port's hook takes it) and once in JAX
(``run_model_jax``, one model, as the JAX hook takes it):

  * K1's layer planes (``model_operands(..., layers=True)``'s twin)
    against the JAX ``voronoi_to_layers_T`` within 3e-6, the validity
    equal to the JAX ``model_is_valid_T``;
  * the cold evaluation of grown states (``eval_cold``) of the custom
    target joined with a P receiver function against the JAX
    evaluator's: each target's synthetics (travel times within 2e-6 s;
    the RF within 5e-5, tests/test_torch_sampler.py) and logL (rtol
    1e-4: the RF's float32 rounding under the whitened Gaussian law, as
    tests/test_torch_sampler.py holds it);
  * one early and one mixed cycle (vs, z, dim, dim, noise) of the custom
    target alone from the same grown states and injected randoms
    against the JAX cycles, as tests/test_torch_cycle.py holds the
    tutorial configuration (the JAX cycles' interpret-mode RF kernel
    would take minutes to compile here);
  * a plugin without ``run_model_torch`` is refused with a message that
    names the hook, and the port's template ``templates/myfwd.py``
    matches the JAX package's ``templates/myfwd.py`` through both
    evaluators.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu import Targets as jtargets  # noqa: E402
from bayhunter_tpu.ops import voronoi as jvor  # noqa: E402
from bayhunter_tpu.sampler.chain import (build_sampler,  # noqa: E402
                                         make_config as jmake_config)
from bayhunter_tpu.sampler.evaluator import (  # noqa: E402
    build_evaluator as jbuild_evaluator)
from bayhunter_tpu_torch import Targets, bench_config, convert  # noqa: E402
from bayhunter_tpu_torch.ops import prep  # noqa: E402
from bayhunter_tpu_torch.sampler import chain as tchain  # noqa: E402
from bayhunter_tpu_torch.sampler import evaluator as tev  # noqa: E402
from bayhunter_tpu_torch.templates import myfwd  # noqa: E402
from test_torch_sampler import (C, jax_draws, target_terms,  # noqa: E402
                                with_adaptation_points, with_wide_noise)

NL = 21
ITERS = 4096
DEPTHS = np.linspace(2.0, 50.0, 12)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def travel_time_torch(h, vs, x):
    """Vertical S time (s) to each depth of ``x`` through (C, NL)
    padded layers: each layer's share of the path over its velocity,
    the halfspace below the stack's bottom."""
    x = torch.as_tensor(x, dtype=h.dtype, device=h.device)
    ztop = torch.cumsum(h, dim=-1) - h
    seg = torch.minimum(torch.clamp(x[None, :, None] - ztop[:, None, :],
                                    min=0.0), h[:, None, :])
    below = torch.clamp(x[None, :] - h.sum(dim=-1, keepdim=True), min=0.0)
    return (seg / vs[:, None, :]).sum(dim=-1) + below / vs[:, -1:]


def travel_time_jax(h, vs, x):
    """:func:`travel_time_torch` of one (NL,) model."""
    x = jnp.asarray(x, h.dtype)
    ztop = jnp.cumsum(h) - h
    seg = jnp.minimum(jnp.maximum(x[:, None] - ztop[None, :], 0.0),
                      h[None, :])
    below = jnp.maximum(x - jnp.sum(h), 0.0)
    return jnp.sum(seg / vs[None, :], axis=1) + below / vs[-1]


class TorchTravelTime:
    def __init__(self, x):
        self.x = np.asarray(x)
        self.modelparams = {}

    def run_model_torch(self, h, vp, vs, rho):
        return travel_time_torch(h, vs, self.x)

    def run_model(self, h, vp, vs, rho, **kw):
        y = self.run_model_torch(*(torch.tensor(np.asarray(v, float))[None]
                                   for v in (h, vp, vs, rho)))[0]
        return self.x, y.numpy()


class JaxTravelTime:
    def __init__(self, x):
        self.x = np.asarray(x)
        self.modelparams = {}

    def run_model_jax(self, h, vp, vs, rho):
        return travel_time_jax(h, vs, self.x)


def _observed():
    h = np.zeros(NL)
    h[:3] = [5., 23., 8.]
    vs = np.full(NL, 4.4)
    vs[:4] = [2.7, 3.6, 3.8, 4.4]
    y = travel_time_torch(torch.tensor(h)[None], torch.tensor(vs)[None],
                          DEPTHS)[0].numpy()
    return y + np.random.RandomState(11).normal(0.0, 0.01, y.size)


def _joints(port_plugin=None, jax_plugin=None, prf=True):
    """(port joint, JAX joint): the custom target, and the P-RF."""
    y = _observed()
    obs = np.loadtxt(os.path.join(bench_config.FIXTURES, 'st3_prf.dat'))
    out = []
    for mod, plugin in ((Targets, port_plugin or TorchTravelTime(DEPTHS)),
                        (jtargets, jax_plugin or JaxTravelTime(DEPTHS))):
        custom = mod.SingleTarget(DEPTHS, y, 'traveltime')
        custom.noiseref = 'swd'
        custom.update_plugin(plugin)
        out.append(mod.JointTarget([custom] + ([mod.PReceiverFunction(
            obs[:, 0], obs[:, 1])] if prf else [])))
    return out


def _cold(joint, jjoint, st, noise):
    """The port's and the JAX ``eval_cold`` of the states ``st`` under
    ``noise``."""
    ip = bench_config.initparams(ITERS)
    ev = tev.build_evaluator(joint, bench_config.PRIORS, ip, NL, 'cpu')
    ej = jbuild_evaluator(jjoint, bench_config.PRIORS, ip, NL)
    got = ev.eval_cold(*(torch.tensor(np.asarray(x)) for x in (
        st.vs, st.z, st.n, st.vpvs, noise)))
    want = jax.vmap(ej.eval_cold)(st.vs, st.z, st.n, st.vpvs,
                                  jnp.asarray(noise))
    return got, want


@pytest.fixture(scope='module')
def samplers():
    """(JAX sampler, JAX evaluator, port sampler) of the custom target
    alone."""
    joint, jjoint = _joints(prf=False)
    ip = bench_config.initparams(ITERS)
    noiserefs = [t.noiseref for t in joint.targets]
    ej = jbuild_evaluator(jjoint, bench_config.PRIORS, ip, NL,
                          use_batch_swd=True, interpret=True)
    sj = build_sampler(ej, jmake_config(bench_config.PRIORS, ip, noiserefs,
                                        nl=NL))
    ev = tev.build_evaluator(joint, bench_config.PRIORS, ip, NL, 'cpu')
    sp = tchain.Sampler(ev, tchain.make_config(bench_config.PRIORS, ip,
                                               noiserefs, nl=NL), 'cpu')
    return sj, ej, sp


@pytest.fixture(scope='module')
def grown(samplers):
    from test_dim_reject_pin import _grown_states
    sj, ej, sp = samplers
    return with_wide_noise(_grown_states(sj, ej, C, nl=NL), ej, sp)


def test_layer_planes_match_jax():
    rs = np.random.RandomState(19)
    nc = 64
    n = rs.randint(1, NL + 1, nc).astype(np.int32)
    vs = np.sort(rs.uniform(1.9, 5.1, (nc, NL)), axis=1).astype(np.float32)
    z = np.sort(rs.uniform(0.0, 62.0, (nc, NL)), axis=1).astype(np.float32)
    for i in range(nc):
        z[i, n[i]:] = 120.0 + np.arange(NL - n[i])
    vpvs = rs.uniform(1.6, 1.9, nc).astype(np.float32)
    ev = tev.build_evaluator(_joints()[0], bench_config.PRIORS,
                             bench_config.initparams(ITERS), NL, 'cpu')
    assert ev.layers
    valid, _, _, layers = prep.model_operands(
        *(torch.tensor(x) for x in (vs.T.copy(), z.T.copy(), n, vpvs)),
        ev.priors, ev.rf_specs, ev.swd_specs, layers=True)
    args = tuple(jnp.asarray(x) for x in (vs.T, z.T, n, vpvs))
    want = jvor.voronoi_to_layers_T(*args)
    for a, b in zip(layers, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=3e-6)
    jvalid = jvor.model_is_valid_T(*args, ev.priors.as_dict,
                                   ev.priors.thickmin, None, None)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < int(valid.sum()) < nc


def test_eval_cold_matches_jax(grown):
    # the custom target's sigma and the RF's (corr 0.98, fixed)
    noise = np.tile(np.float32([0.0, 0.03, 0.98, 0.015]), (C, 1))
    (logL, _, valid, cache), want = _cold(*_joints(), grown, noise)
    assert bool(valid.all()) and bool(np.asarray(want[2]).all())
    np.testing.assert_allclose(cache[0][0].numpy(), np.asarray(want[3][0][0]),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(cache[1][0].numpy(), np.asarray(want[3][1][0]),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(logL.numpy(), np.asarray(want[0]), rtol=1e-4)
    assert cache[0][1].shape == (C, 0)


@pytest.mark.parametrize('late', [False, True], ids=['early', 'mixed'])
def test_cycle_matches_jax(samplers, grown, late):
    sj, ej, sp = samplers
    order = sp.late_order if late else sp.early_order
    st = with_adaptation_points(grown, len(order))
    marginal = []
    log_alpha = sp.log_alpha

    def recording(states, prop, logL_p):
        alpha = log_alpha(states, prop, logL_p)
        marginal.append((prop['logu'] - alpha).abs() < 1e-3)
        return alpha

    sp.log_alpha = recording
    try:
        ps0 = ps = convert.state_from_numpy(st, 'cpu')
        keys = st.key
        zmin, zmax = sp.cfg.z_prior
        before = prep.model_operands.launches
        for move in order:
            keys, draws = jax_draws(keys, ps.n.numpy(), move, zmin, zmax,
                                    len(sp.cfg.noiseinds))
            ps = sp.step(ps, move, draws)
        assert prep.model_operands.launches == before   # the twin ran
    finally:
        sp.log_alpha = log_alpha
    cycle = sj.cycle_mixed_fn if late else sj.cycle_early_fn
    js = cycle(jax.tree.map(jnp.copy, st))
    ok = ~torch.stack(marginal).any(dim=0).numpy()
    assert ok.sum() >= C - 1
    for f in ('n', 'accepted', 'proposed', 'fwdfail', 'iiter'):
        assert np.array_equal(getattr(ps, f).numpy()[ok],
                              np.asarray(getattr(js, f))[ok]), f
    for f in ('vs', 'z'):
        np.testing.assert_allclose(getattr(ps, f).numpy()[ok],
                                   np.asarray(getattr(js, f))[ok], rtol=0,
                                   atol=1e-6)
    # the term, -n log sigma - chi^2 / 2, held to 1e-4 of the magnitude
    # of its parts, which can cancel to a total near 0
    terms = target_terms(sp, ps.cache, ps.noise)[0]
    n = len(DEPTHS)
    parts = np.abs(terms) + 2 * n * np.abs(np.log(ps.noise.numpy()[:, 1]))
    d = np.abs(terms - target_terms(sp, js.cache, js.noise)[0])
    assert np.all(d[ok] <= 1e-4 * parts[ok]), (d / parts)[ok].max()
    assert np.all(np.abs(ps.logL.numpy() - np.asarray(js.logL))[ok]
                  <= 1e-4 * parts[ok])
    np.testing.assert_allclose(ps.cache[0][0].numpy()[ok],
                               np.asarray(js.cache[0][0])[ok], rtol=0,
                               atol=2e-6)
    accepted = (ps.accepted - ps0.accepted).numpy().sum(axis=0)
    assert accepted[0] > 0 and accepted[1] > 0
    if late:
        assert accepted[2] > 0
    assert np.array_equal(ps.propdist.numpy(),
                          np.asarray(js.propdist, np.float32))


def test_missing_hook_is_refused():
    class HostOnly:
        modelparams = {}

        def run_model(self, h, vp, vs, rho, **kw):
            return DEPTHS, np.zeros(DEPTHS.size)

    joint = _joints(port_plugin=HostOnly())[0]
    with pytest.raises(NotImplementedError, match='run_model_torch'):
        tev.build_evaluator(joint, bench_config.PRIORS,
                            bench_config.initparams(10), NL, 'cpu')


def test_template_matches_the_jax_template(grown):
    spec = importlib.util.spec_from_file_location(
        'jax_myfwd', os.path.join(ROOT, 'templates', 'myfwd.py'))
    jmyfwd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmyfwd)
    got, want = _cold(*_joints(myfwd.MyForwardModel(DEPTHS, 'traveltime'),
                               jmyfwd.MyForwardModel(DEPTHS, 'traveltime'),
                               prf=False), grown, grown.noise)
    np.testing.assert_allclose(got[3][0][0].numpy(),
                               np.asarray(want[3][0][0]), rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    x, yh = myfwd.MyForwardModel(DEPTHS, 'x').run_model(
        [5.0, 0.0], [4.6, 7.6], [2.7, 4.4], [2.2, 3.2])
    assert np.array_equal(x, DEPTHS) and np.allclose(yh, 3.55)
