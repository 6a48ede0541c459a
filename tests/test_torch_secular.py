"""Plain twins of kernels K4 (Rayleigh) and K5 (Love) vs the JAX
package's Pallas secular kernels (interpret mode on the CPU), and the
port's cold root search for both wave types vs ``surfdisp_roots_batch``
and the tutorial golden data, float32."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu.ops.pallas_secular import (  # noqa: E402
    dltar1_pallas, dltar4_pallas)
from bayhunter_tpu.ops.swd import surfdisp_roots_batch  # noqa: E402
from bayhunter_tpu_torch.ops import swd  # noqa: E402
from bayhunter_tpu_torch.ops import voronoi as tvor  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
NL = 8
WAVES = [pytest.param(2, id='rayleigh'), pytest.param(1, id='love')]


def _grown_layers(C=8, seed=3):
    """(C, NL) layer arrays of seeded 3-7 layer models around the
    tutorial truth (the ensemble of tests/test_dim_reject_pin.py, cut
    to NL = 8 slots)."""
    rs = np.random.RandomState(seed)
    VS = np.zeros((C, NL), np.float32)
    Z = np.zeros((C, NL), np.float32)
    N = np.zeros(C, np.int32)
    for i in range(C):
        n = 4 + rs.randint(0, 5)
        znuc = np.sort(np.concatenate([
            np.array([2.5, 15., 32., 48.]) + rs.uniform(-1.5, 1.5, 4),
            rs.uniform(1., 58., n - 4)]))
        vsn = np.interp(znuc, [0, 5, 5.01, 28, 28.01, 36, 36.01, 60],
                        [2.7, 2.7, 3.6, 3.6, 3.8, 3.8, 4.4, 4.4])
        VS[i, :n] = np.sort(vsn + rs.normal(0, 0.05, n))
        VS[i, n:] = VS[i, n - 1]
        Z[i, :n] = znuc
        Z[i, n:] = 120.0
        N[i] = n
    vpvs = torch.full((C,), 1.73)
    return tvor.voronoi_to_layers(torch.tensor(VS), torch.tensor(Z),
                                  torch.tensor(N), vpvs)


@pytest.mark.parametrize('iwave', WAVES)
def test_secular_twin_matches_pallas(iwave):
    h, vp, vs, rho = _grown_layers()
    C, L = h.shape[0], 128
    rs = np.random.RandomState(11)
    c = rs.uniform(2.0, 4.8, (C, L)).astype(np.float32)
    om = (2 * np.pi / rs.uniform(1.0, 41.0, (C, L))).astype(np.float32)
    wv = om / c
    lay = [jnp.asarray(x.numpy()) for x in (h, vp, vs, rho)]
    if iwave == 1:
        ref = dltar1_pallas(jnp.asarray(wv), jnp.asarray(om), lay[0], lay[2],
                            lay[3], interpret=True)
    else:
        ref = dltar4_pallas(jnp.asarray(wv), jnp.asarray(om), *lay,
                            interpret=True)
    ref = np.asarray(ref)
    got = swd.secular_values(torch.tensor(wv), torch.tensor(om), h, vp, vs,
                             rho, iwave).numpy()
    assert np.isfinite(got).all()
    rowmax = np.abs(ref).max(axis=1, keepdims=True)
    big = np.abs(ref) > 1e-5 * rowmax
    assert big.mean() > 0.9
    assert np.array_equal(np.sign(got)[big], np.sign(ref)[big])
    assert (np.sign(ref[big]) > 0).any() and (np.sign(ref[big]) < 0).any()
    np.testing.assert_allclose(got / np.abs(got).max(axis=1, keepdims=True),
                               ref / rowmax, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('iwave', WAVES)
def test_cold_roots_match_jax(iwave):
    h, vp, vs, rho = _grown_layers(C=12, seed=5)
    periods = np.linspace(1, 41, 21).astype(np.float32)
    cg, err, roots, slopes = swd.surfdisp_roots_cold(h, vp, vs, rho, periods,
                                                     iwave)
    cj, errj, rj, sj = surfdisp_roots_batch(
        *(jnp.asarray(x.numpy()) for x in (h, vp, vs, rho)),
        jnp.asarray(periods), c_prev=None, iwave=iwave, return_slopes=True,
        interpret=True)
    found_j = np.asarray(sj) != 0.0
    found = slopes.numpy() != 0.0
    assert np.array_equal(found, found_j)
    assert found.mean() > 0.9
    assert np.array_equal(err.numpy(), np.asarray(errj))
    d = np.abs(roots.numpy() - np.asarray(rj))[found]
    assert d.max() <= 2e-6, d.max()


@pytest.mark.parametrize('name,iwave', [('st3_rdispph.dat', 2),
                                        ('st3_ldispph.dat', 1)])
def test_tutorial_golden_cold_f32(name, iwave):
    """The tutorial truth model (tests/conftest.py tutorial_model)
    through the cold solve, against the committed golden data."""
    obs = np.loadtxt(os.path.join(FIXTURES, name))
    h = np.zeros((1, 21), np.float32)
    h[0, :3] = [5., 23., 8.]
    vs = np.full((1, 21), 4.4, np.float32)
    vs[0, :4] = [2.7, 3.6, 3.8, 4.4]
    vp = vs * np.float32(1.73)
    rho = vp * np.float32(0.32) + np.float32(0.77)
    cg, err, _, _ = swd.surfdisp_roots_cold(
        *(torch.tensor(x) for x in (h, vp, vs, rho)),
        obs[:, 0].astype(np.float32), iwave)
    assert not bool(err[0])
    np.testing.assert_allclose(cg[0].numpy(), obs[:, 1], rtol=0, atol=1e-4)
