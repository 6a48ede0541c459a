"""K6's unflattened arm and the batched RF forward without the earth
flattening, against the JAX package:

  * K6's plain twin ``prep.rf_operands(..., flattening=False)`` on the
    CPU against the JAX ``rf_operands_t(..., flattening=False)`` (the
    Pallas kernel ``_prep_kernel`` in interpret mode, ``_rf_rows``
    without its flattening block), P and SV, float32: tables and pack
    within 3e-6 (the JAX kernel sums t0 in another order), the skip
    depth exact;
  * ``rf.synrf_batch(flattening=False)`` against the JAX
    ``synrf_batch(layout_t=True, flattening=False)`` (its prep and
    packed response kernels in interpret mode), float32, within 5e-6 on
    RFs of amplitude 0.2 (the flattened arm of the same models reads
    2.5e-6 from the JAX package; the two packages round the response
    and the deconvolution in float32 apart);
  * ``rf.synrf(flattening=False)`` in float64 against the JAX float64
    ``synrf``, P and SV, (fz, fr, rf) within 1e-10, and the flattening
    moving the RF.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayhunter_tpu.ops import rf as jrf
from bayhunter_tpu.ops.pallas_prep import rf_operands_t
from bayhunter_tpu_torch.ops import prep, rf

C, NL = 8, 6
P_SKM = 6.4 * rf.DEG_PER_KM
WAVES = pytest.mark.parametrize('wave', [rf.P_WAVE, rf.SV_WAVE],
                                ids=['P', 'SV'])


def _models(seed=5):
    """(C, NL) float32 layer arrays of 1-5 layer models (chain 0 a pure
    halfspace) and their rotation's nsv and Poisson ratio."""
    rs = np.random.RandomState(seed)
    H = np.zeros((C, NL), np.float32)
    VS = np.zeros((C, NL), np.float32)
    for i in range(C):
        n = 1 + i % 5
        H[i, :n - 1] = rs.uniform(2, 12, n - 1)
        v = np.sort(rs.uniform(2.5, 4.5, n))
        VS[i] = v[-1]
        VS[i, :n] = v
    VP = VS * np.float32(1.73)
    RHO = VP * np.float32(0.32) + np.float32(0.77)
    vpvs = VP[:, 0] / VS[:, 0]
    return (H, VP, VS, RHO), VS[:, 0], (2 - vpvs ** 2) / (2 - 2 * vpvs ** 2)


@WAVES
def test_unflattened_operands_match_jax(wave):
    layers, _, _ = _models()
    jc, jp = (np.asarray(x) for x in rf_operands_t(
        *(jnp.asarray(x.T) for x in layers), P_SKM, wave,
        flattening=False, interpret=True))
    pc, pp = (x.numpy() for x in prep.rf_operands(
        *(torch.tensor(x.T.copy()) for x in layers), P_SKM, wave,
        flattening=False))
    assert pc.shape == jc.shape and pp.shape == jp.shape
    np.testing.assert_allclose(pc, jc, rtol=0, atol=3e-6)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=3e-6)
    off = rf.pack_offsets(NL)
    assert np.array_equal(pp[off['depth']], jp[off['depth']])
    # the pack carries the raw layers
    assert np.array_equal(pp[off['h']:off['h'] + NL], layers[0].T)
    assert np.array_equal(pp[off['vs']:off['vs'] + NL], layers[2].T)
    # and the flattened arm does not
    fp = prep.rf_operands(*(torch.tensor(x.T.copy()) for x in layers),
                          P_SKM, wave)[1].numpy()
    assert not np.array_equal(fp[off['vs']:off['vs'] + NL], layers[2].T)


def test_unflattened_synrf_batch_matches_jax():
    layers, nsv, poisson = _models()
    got = rf.synrf_batch(*layers, 500.0, 225.0, 6.4, 1.0, 512, 5.0, 5.0,
                         nsv, poisson, flattening=False,
                         device='cpu').numpy()
    want = np.asarray(jrf.synrf_batch(
        *(jnp.asarray(x.T) for x in layers), 500.0, 225.0, 6.4, 1.0, 512,
        5.0, 5.0, jnp.asarray(nsv), jnp.asarray(poisson), flattening=False,
        layout_t=True, interpret=True))
    assert got.shape == want.shape == (C, 512)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@WAVES
def test_unflattened_synrf_f64_matches_jax(wave):
    rs = np.random.RandomState(21)
    nl = 10
    h = np.zeros(nl)
    h[:5] = rs.uniform(2, 12, 5)
    vs = np.sort(rs.uniform(2.5, 4.5, nl))
    vs[6:] = vs[5]
    vp = 1.73 * vs
    rho = 0.32 * vp + 0.77
    args = (6.4, 1.0, 256, 5.0, 5.0, vs[0], 0.25)
    got = rf.synrf(*(torch.tensor(x) for x in (h, vp, vs, rho)), 500.0,
                   225.0, *args, wave_type=wave, flattening=False,
                   device='cpu')
    want = jrf.synrf(*(jnp.asarray(x) for x in (h, vp, vs, rho)),
                     jnp.full(nl, 500.0), jnp.full(nl, 225.0), *args,
                     wave_type=wave, flattening=False)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)
    flat = rf.synrf(*(torch.tensor(x) for x in (h, vp, vs, rho)), 500.0,
                    225.0, *args, wave_type=wave, device='cpu')[2]
    assert float((flat - got[2]).abs().max()) > 1e-4
