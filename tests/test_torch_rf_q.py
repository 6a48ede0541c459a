"""The port's batched RF forward ``rf.synrf_batch`` (plain twins of K6,
K3 and K3r on the CPU) vs the JAX package's ``rf.synrf_batch`` on its
row-major arm (the Pallas response kernel in interpret mode), float32:

  * per-layer Q drawn at random, chains of 2 and 8 layers in one batch,
    P and SV incidence (atol 1e-5);
  * scalar Q against the same Q as uniform arrays (K3 against K3r,
    tests/test_pallas.py:1050);
  * a Q contrast across a zero-thickness slot raises the skip depth;
  * the tutorial model against the S-RF golden (f32, 5e-4);
  * ``rf.synrf``'s (fz, fr, rf) against the JAX ``synrf`` (f32, 5e-4);

and the K3r twin in float64 against the independent native reflectivity
(``bayhunter_tpu.native``) on the 80-model sweep of
tests/test_rf_sweep.py with per-layer Q, P and SV (< 2e-6).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu.ops import rf as jrf  # noqa: E402
from bayhunter_tpu_torch.ops import prep, rf  # noqa: E402
from conftest import golden_path  # noqa: E402

NL, C = 12, 16
NSAMP, FSAMP, TSHIFT, GAUSS, P_SDEG = 512, 5.0, 5.0, 1.0, 6.4
WAVES = pytest.mark.parametrize('wave', [rf.P_WAVE, rf.SV_WAVE],
                                ids=['P', 'SV'])


def _mixed(seed=7):
    """(C, NL) layer arrays of chains with 2 and 8 layers (float32)."""
    rs = np.random.RandomState(seed)
    H = np.zeros((C, NL), np.float32)
    VS = np.zeros((C, NL), np.float32)
    for i in range(C):
        nlay = 2 if i % 2 == 0 else 8
        H[i, :nlay - 1] = rs.uniform(2, 12, nlay - 1)
        vv = np.sort(rs.uniform(2.5, 4.5, nlay))
        VS[i] = vv[-1]
        VS[i, :nlay] = vv
    VP = VS * np.float32(1.73)
    RHO = VP * np.float32(0.32) + np.float32(0.77)
    return H, VP, VS, RHO


def q_model(rs, shape):
    """Per-layer Qs in 50-600 increasing with depth along the last axis,
    and Qp = 2.25 Qs."""
    qs = np.sort(rs.uniform(50.0, 600.0, shape), axis=-1)
    return (2.25 * qs).astype(np.float32), qs.astype(np.float32)


def _rotation(VP, VS):
    """Per-chain near-surface S velocity and Poisson ratio."""
    vpvs0 = VP[:, 0] / VS[:, 0]
    return VS[:, 0], (2 - vpvs0 ** 2) / (2 - 2 * vpvs0 ** 2)


def _port(layers, qp, qs, wave, fref=1.0):
    nsv, poisson = _rotation(layers[1], layers[2])
    return rf.synrf_batch(*layers, qp, qs, P_SDEG, GAUSS, NSAMP, FSAMP,
                          TSHIFT, nsv, poisson, wave_type=wave, fref=fref,
                          device='cpu').numpy()


def _jax(layers, qp, qs, wave, fref=1.0):
    nsv, poisson = _rotation(layers[1], layers[2])
    q = tuple(x if isinstance(x, float) else jnp.asarray(x)
              for x in (qp, qs))
    return np.asarray(jrf.synrf_batch(
        *(jnp.asarray(x) for x in layers), *q, P_SDEG, GAUSS, NSAMP, FSAMP,
        TSHIFT, jnp.asarray(nsv), jnp.asarray(poisson), wave_type=wave,
        fref=fref, interpret=True))


@WAVES
def test_array_q_twin_matches_jax(wave):
    layers = _mixed()
    qp, qs = q_model(np.random.RandomState(3), (C, NL))
    a = _port(layers, qp, qs, wave)
    b = _jax(layers, qp, qs, wave)
    assert a.shape == (C, NSAMP)
    assert np.abs(b).max() > 0.05
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    # the anelastic phase matters at this tolerance: uniform Q differs
    c = _port(layers, 500.0, 225.0, wave)
    assert np.abs(c - b).max() > 1e-3


@WAVES
def test_scalar_q_matches_uniform_arrays(wave):
    """K3 (scalar default Q) and K3r (the same Q as arrays) agree, and
    K3r with scalar Q at another reference frequency agrees with JAX;
    fref moves the RF."""
    layers = _mixed(seed=9)
    full = np.full((C, NL), 1.0, np.float32)
    a = _port(layers, 500.0, 225.0, wave)
    b = _port(layers, 500.0 * full, 225.0 * full, wave)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    c = _port(layers, 500.0, 225.0, wave, fref=2.0)
    np.testing.assert_allclose(c, _jax(layers, 500.0, 225.0, wave,
                                       fref=2.0), rtol=0, atol=1e-5)
    assert np.abs(c - a).max() > 1e-4


def test_q_contrast_raises_skip_depth():
    """The pack's depth counts elastic contrasts; a Q contrast below a
    zero-thickness slot raises it (pallas_rf.py:804-811), and the RF
    then agrees with JAX for both waves."""
    H, VP, VS, RHO = _mixed(seed=11)
    qp, qs = q_model(np.random.RandomState(5), (C, NL))
    # chain 0 (2 layers): Q contrast below slot 4; chain 1 (8 layers):
    # uniform Q in its padding, so its depth stays 6
    qp[0, :5], qp[0, 5:], qs[0] = qp[0, 0], qp[0, 5], qs[0, 0]
    qp[1, 7:], qs[1, 7:] = qp[1, 7], qs[1, 7]
    _, pack = prep.rf_operands(*(torch.tensor(x.T.copy()) for x in (
        H, VP, VS, RHO)), P_SDEG * rf.DEG_PER_KM)
    depth = pack[rf.pack_offsets(NL)['depth']]
    raised = rf.q_depth(depth, torch.tensor(qp.T.copy()),
                        torch.tensor(qs.T.copy()))
    assert float(depth[0]) == 0.0 and float(raised[0]) == 4.0
    assert float(depth[1]) == float(raised[1]) == 6.0
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        np.testing.assert_allclose(_port((H, VP, VS, RHO), qp, qs, wave),
                                   _jax((H, VP, VS, RHO), qp, qs, wave),
                                   rtol=0, atol=1e-5)


@WAVES
def test_tutorial_golden_f32(wave):
    """The tutorial truth model through ``synrf`` with uniform Q given as
    arrays (K3r) against the P- and S-RF goldens (f32 bound of
    tests/test_rf.py:50-54)."""
    obs = np.loadtxt(golden_path('st3_%s.dat' % ('prf', 'srf')[wave]))
    nl = 21
    h = np.zeros(nl, np.float32)
    h[:3] = [5., 23., 8.]
    vs = np.full(nl, 4.4, np.float32)
    vs[:4] = [2.7, 3.6, 3.8, 4.4]
    vp = vs * np.float32(1.73)
    rho = vp * np.float32(0.32) + np.float32(0.77)
    nsv, poisson = _rotation(vp[None], vs[None])
    y = rf.synrf(h, vp, vs, rho, np.full(nl, 500.0), np.full(nl, 225.0),
                 P_SDEG, GAUSS, NSAMP, FSAMP, TSHIFT, nsv, poisson,
                 wave_type=wave, device='cpu')[2].numpy()
    np.testing.assert_allclose(y[:obs.shape[0]], obs[:, 1], rtol=0,
                               atol=5e-4)


@WAVES
def test_synrf_traces_match_jax(wave):
    """``synrf``'s (fz, fr, rf) against the JAX package's ``synrf`` on
    one seeded 8-layer model with per-layer Q, float32, within the f32
    bound of tests/test_rf.py:50-54 (5e-4) and, since the Z and R traces
    peak below 0.1, within 1e-3 of each trace's peak (the port sums the
    Gauss-cut lanes, the JAX package all of them)."""
    H, VP, VS, RHO = _mixed(seed=13)
    qp, qs = q_model(np.random.RandomState(9), (C, NL))
    model = tuple(x[1] for x in (H, VP, VS, RHO, qp, qs))
    nsv, poisson = (float(x[0]) for x in _rotation(VP[1:2], VS[1:2]))
    got = rf.synrf(*model, P_SDEG, GAUSS, NSAMP, FSAMP, TSHIFT, nsv,
                   poisson, wave_type=wave, device='cpu')
    want = jrf.synrf(*(jnp.asarray(x) for x in model), P_SDEG, GAUSS,
                     NSAMP, FSAMP, TSHIFT, nsv, poisson, wave_type=wave)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape == (NSAMP,)
        peak = np.abs(b).max()
        assert peak > 0.02
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-4)
        assert np.abs(a.numpy() - b).max() <= 1e-3 * peak


@WAVES
def test_native_sweep_f64(wave):
    """The K3r twin (with K6's twin, the deconvolution and the full
    inverse FFT) in float64 against the native golden on the 80 models
    of tests/test_rf_sweep.py, each with its own per-layer Q."""
    native = pytest.importorskip('bayhunter_tpu.native')
    if native.load() is None:
        pytest.skip('native library unavailable')
    from test_rf_sweep import KINDS, N_PER_KIND, make_model
    nl, nsamp = 10, 256
    # the models, slownesses and Gauss widths of test_rf_sweep.py; the
    # Q models from a stream of their own
    rs = np.random.RandomState(1234)
    rq = np.random.RandomState(77)
    worst, ncases = 0.0, 0
    for kind in KINDS:
        for i in range(N_PER_KIND):
            h, vp, vs, rho = make_model(rs, kind)
            p, g = [(rs.uniform(4.5, 8.0), rs.uniform(0.6, 3.0))
                    for _ in range(2)][wave]
            qp, qs = (q.astype(float) for q in q_model(rq, len(h)))
            rf_n = native.synrf_native(h, vp, vs, rho, qp, qs, p, g, nsamp,
                                       FSAMP, TSHIFT, vs[0], 0.25,
                                       wave_type=wave)[2]
            planes = tuple(torch.tensor(np.concatenate(
                [x, np.full(nl - len(x), x[-1] if j else 0.0)]))[:, None]
                for j, x in enumerate((h, vp, vs, rho, qp, qs)))
            coefs, pack = prep.rf_operands(*planes[:4], p * rf.DEG_PER_KM,
                                           wave)
            resp = rf.transmission_response_q(
                coefs, pack, *planes[4:], nsamp // 2 + 1, nsamp, FSAMP,
                wave)
            vs0 = torch.tensor([vs[0]], dtype=torch.float64)
            fr, fi = rf.deconvolve(*resp, pack[rf.pack_offsets(nl)['p']],
                                   vs0 * np.sqrt(3.0), vs0, wave)
            rf_t = rf.inverse_transform(fr, fi, nsamp, FSAMP, TSHIFT, g)
            d = float(np.abs(rf_t[0].numpy() - rf_n).max())
            worst = max(worst, d)
            ncases += 1
            assert d < 2e-6, '%s[%d] p=%.2f g=%.2f maxdiff %.2e' % (
                kind, i, p, g, d)
    assert ncases == len(KINDS) * N_PER_KIND
    assert np.isfinite(worst)
