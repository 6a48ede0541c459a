"""``tutorial_prf_srf`` (Rayleigh phase, P-RF and S-RF targets) in the
port vs the JAX package (CPU, float32):

  * K1's twin with one operand set per RF target against
    ``pallas_prep.model_operands_t`` with the matching ``specs`` tuple
    (interpret mode);
  * the initial states of 64 chains;
  * one early cycle from the JAX package's grown states carried across
    with ``convert.state_from_numpy`` (three-target forward cache
    included) and the JAX chains' randoms injected, 12 chains, NL = 8.

The mixed cycle is in test_torch_prf_srf_cycle.py; the helpers in
test_torch_sampler.py.
"""

import os
import sys

import numpy as np

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu.ops.pallas_prep import model_operands_t  # noqa: E402
from bayhunter_tpu_torch.ops import prep, rf  # noqa: E402
from conftest import run_isolated  # noqa: E402
from test_torch_kernels import (  # noqa: E402
    CFGT, NL, P_SKM, _ensemble, _priors, _t)

NL_CYCLE = 8
S_SKM = 6.4 * rf.DEG_PER_KM


def test_model_operands_rf_specs_twin_matches_jax():
    vs_t, z_t, n, vpvs = _ensemble()
    specs = (('swd', 2, 0), ('rf', P_SKM, rf.P_WAVE, True),
             ('rf', S_SKM, rf.SV_WAVE, True))
    jv, (jsw, *jrf) = model_operands_t(
        *(jnp.asarray(x) for x in (vs_t, z_t, n, vpvs)), specs, CFGT,
        interpret=True)
    tv, tsw, trf = prep.model_operands(
        _t(vs_t), _t(z_t), _t(n), _t(vpvs), _priors(),
        tuple(sp[1:3] for sp in specs[1:]))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    for a, b in zip(tsw, jsw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=3e-6)
    off = rf.pack_offsets(NL)
    # the skip depth row: see test_torch_kernels.py (the JAX kernel's
    # CPU flattening may sit it deeper)
    rows = np.arange(off['rows']) != off['depth']
    assert len(trf) == 2
    for (tc, tp), (jc, jp) in zip(trf, jrf):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=3e-6)
        np.testing.assert_allclose(tp.numpy()[rows], np.asarray(jp)[rows],
                                   rtol=0, atol=3e-6)
    # the two sets share the slowness and differ in the direct-arrival
    # time t0 only, on every chain
    assert np.array_equal(trf[0][0].numpy(), trf[1][0].numpy())
    t0 = off['t0']
    differ = (trf[0][1] != trf[1][1]).any(dim=1).numpy()
    assert np.flatnonzero(differ).tolist() == [t0]
    assert bool((trf[1][1][t0] != trf[0][1][t0]).all())


def test_init_states_match_jax_prf_srf():
    if run_isolated('tests/test_torch_prf_srf.py::'
                    'test_init_states_match_jax_prf_srf'):
        return
    from test_torch_sampler import compare_init
    ps = compare_init('tutorial_prf_srf', nl=NL_CYCLE, chains=64,
                      terms=True)
    assert len(ps.cache) == 3 and ps.misfits.shape == (64, 4)
    assert ps.noise.shape == (64, 6)


def test_early_cycle_matches_jax_prf_srf():
    if run_isolated('tests/test_torch_prf_srf.py::'
                    'test_early_cycle_matches_jax_prf_srf'):
        return
    from test_torch_sampler import compare_cycle
    compare_cycle(late=False, config='tutorial_prf_srf', nl=NL_CYCLE)
