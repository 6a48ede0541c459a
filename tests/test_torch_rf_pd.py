"""The port's linearized RF inversion (``ops/rf_pd.py``: the
``torch.func`` Jacobian through the plain RF twins, the truncated-SVD
solve, the Gauss-Newton loop) against the JAX package's
``ops/rf_pd.py`` on the cases of tests/test_rf_pd.py, float64:

  * ``_parameter_basis`` exactly (the padded model and a pure
    halfspace), and batched over a leading model axis;
  * ``rf_partials``'s RF window within 1e-12 and its Jacobian within
    1e-9 of the JAX Jacobian's largest entry, for each ``rho_coupling``
    (bayhunter, berteussen, fixed), padded columns exactly zero;
  * ``truncated_svd_solve`` within 1e-10 (rank-deficient J, with and
    without damping);
  * ``invert_rf``'s rms trace within 1e-8 of the JAX trace, the
    recovery bound rms[-1] < 1e-2 rms[0] and vs within 2e-3 (the JAX
    test's), and two models batched in one call equal to each alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayhunter_tpu.ops import rf_pd as jpd
from bayhunter_tpu.ops.rf import synrf as jsynrf
from bayhunter_tpu_torch.ops import rf_pd

NL = 8
NSAMP, NUSED = 256, 128
VPVS = 1.73
POISSON = (2 - VPVS ** 2) / (2 - 2 * VPVS ** 2)
KW = dict(p_sdeg=6.4, gauss_a=1.0, nsamp=NSAMP, fsamp=5.0, tshift=5.0,
          nsv=2.7, poisson=POISSON)


def _padded(vs_active=(2.7, 3.6, 3.8, 4.4)):
    h = np.zeros(NL)
    h[:3] = [5., 23., 8.]
    vs = np.full(NL, vs_active[-1])
    vs[:len(vs_active)] = vs_active
    vp = vs * VPVS
    return h, vp, vs, 0.32 * vp + 0.77


def _torch(*xs):
    return tuple(torch.tensor(x) for x in xs)


def _jnp(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def test_parameter_basis_matches_jax():
    h = _padded()[0]
    for hh in (h, np.zeros(4)):
        want = np.asarray(jpd._parameter_basis(jnp.asarray(hh),
                                               jnp.float64))
        got = rf_pd._parameter_basis(torch.tensor(hh), torch.float64)
        assert np.array_equal(got.numpy(), want)
    both = rf_pd._parameter_basis(torch.tensor(np.stack([h, h * 0])),
                                  torch.float64)
    assert torch.equal(both[0], rf_pd._parameter_basis(torch.tensor(h),
                                                       torch.float64))


@pytest.mark.parametrize('coupling', ['bayhunter', 'berteussen', 'fixed'])
def test_jacobian_matches_jax(coupling):
    h, vp, vs, rho = _padded()
    got_rf, got_J = rf_pd.rf_partials(
        *_torch(h, vp, vs), 500.0, 225.0, nused=NUSED,
        rho_coupling=coupling, rho=torch.tensor(rho), **KW)
    want_rf, want_J = (np.asarray(x) for x in jpd.rf_partials(
        *_jnp(h, vp, vs), jnp.full(NL, 500.0), jnp.full(NL, 225.0),
        nused=NUSED, rho_coupling=coupling, rho=jnp.asarray(rho), **KW))
    assert got_J.shape == want_J.shape == (NUSED, NL)
    np.testing.assert_allclose(got_rf.numpy(), want_rf, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_J.numpy(), want_J, rtol=0,
                               atol=1e-9 * np.abs(want_J).max())
    assert float(got_J[:, 4:].abs().max()) == 0.0
    assert float(got_J[:, 3].norm()) > 1e-3


def test_truncated_svd_solve_matches_jax():
    rng = np.random.RandomState(7)
    J = rng.randn(40, 3) @ rng.randn(3, 3)
    J = np.concatenate([J, np.zeros((40, 2))], axis=1)
    b = J @ np.array([0.1, -0.2, 0.05, 0.0, 0.0])
    for rcond, damping in ((1e-10, 0.0), (1e-4, 0.05), (0.999, 0.0)):
        got = rf_pd.truncated_svd_solve(torch.tensor(J), torch.tensor(b),
                                        rcond, damping).numpy()
        want = np.asarray(jpd.truncated_svd_solve(
            jnp.asarray(J), jnp.asarray(b), rcond, damping))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(J @ rf_pd.truncated_svd_solve(
        torch.tensor(J), torch.tensor(b), 1e-10).numpy(), b, atol=1e-10)


def test_invert_rf_matches_jax_and_recovers():
    h, vp, vs, rho = _padded()
    rf_obs = np.asarray(jsynrf(*_jnp(h, vp, vs, rho), jnp.full(NL, 500.0),
                               jnp.full(NL, 225.0), 6.4, 1.0, NSAMP, 5.0,
                               5.0, 2.7, POISSON)[2])[:NUSED]
    rng = np.random.RandomState(3)
    dvs = np.zeros(NL)
    dvs[:4] = rng.uniform(-0.08, 0.08, 4)
    dvs[3] = 0.06
    dvs[4:] = dvs[3]
    vs0 = vs + dvs
    kw = dict(nused=NUSED, niter=6, rcond=1e-6, damping=0.01, **KW)
    got_vs, got_rms = rf_pd.invert_rf(
        *_torch(rf_obs, h, vs0 * VPVS, vs0), 500.0, 225.0, **kw)
    want_vs, want_rms = (np.asarray(x) for x in jpd.invert_rf(
        *_jnp(rf_obs, h, vs0 * VPVS, vs0), jnp.full(NL, 500.0),
        jnp.full(NL, 225.0), **kw))
    np.testing.assert_allclose(got_rms.numpy(), want_rms, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_vs.numpy(), want_vs, rtol=0, atol=1e-8)
    rms = got_rms.numpy()
    assert rms[-1] < 1e-2 * rms[0], rms
    assert np.abs(got_vs.numpy() - vs)[:4].max() < 2e-3
    np.testing.assert_allclose(got_vs.numpy()[4:], got_vs.numpy()[3],
                               atol=1e-12)
    # two models in one call: each as alone
    obs2, h2, vp2, vs2 = (np.stack([x, x]) for x in (rf_obs, h,
                                                     vs0 * VPVS, vs0))
    vs2[1, :4] += 0.02
    vp2[1] = vs2[1] * VPVS
    kw3 = dict(kw, niter=3)
    both = rf_pd.invert_rf(*_torch(obs2, h2, vp2, vs2), 500.0, 225.0, **kw3)
    for i in range(2):
        one = rf_pd.invert_rf(*_torch(obs2[i], h2[i], vp2[i], vs2[i]),
                              500.0, 225.0, **kw3)
        np.testing.assert_allclose(both[1][i].numpy(), one[1].numpy(),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(both[0][i].numpy(), one[0].numpy(),
                                   rtol=0, atol=1e-12)
