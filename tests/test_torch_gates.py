"""The JAX package's sampler gates held on the port's CPU twins
(``bayhunter_tpu_torch/gates.py``), with the JAX tests' bands:

  * the dimension-reject pin (``tests/test_dim_reject_pin.py``): birth
    <= 10 %, death 12-33 %, combined 5-17 % at 128 chains;
  * the converged band (``tests/test_dim_reject_converged.py``): 6-22 %
    from the tutorial's captured snapshot tiled to 252 chains;
  * the warm walker against the float64 golden
    (``tests/test_swd_sweep.py``
    ``test_walker_warm_refinement_error_bounded``): at least 250 lanes,
    median < 2e-6, p99 < 2e-5, at most 1 % of lanes root-selection
    outliers, against the native golden and against the port's own
    float64 cold solve (the golden ``chip_smoke.py`` takes on the card,
    which may not import the JAX package), which first is held to the
    native golden here.

The prior-only layer histogram is ``tests/test_torch_prior_sampling.py``.
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from bayhunter_tpu_torch import gates

native = pytest.importorskip('bayhunter_tpu.native')
if native.load() is None:  # pragma: no cover
    pytest.skip('native library unavailable', allow_module_level=True)

# the port's float64 cold solve against the native one: the same error
# flags and roots within its last bracket, DDC / 16**3 (three 15-point
# refinement passes, then a secant), with no more than 1 % of the lanes
# further than 1e-10 apart.  Measured on the walker's 30 models: 1e-12
# but on the 2 s lane of three low-velocity-zone models, 1.3e-8,
# 5.1e-8 and 4.5e-7 (the native root is the closer one there), far
# under the walker's bounds (median 2e-6, p99 2e-5)
GOLDEN_TOL = 0.005 / 16 ** 3
GOLDEN_CLOSE = 1e-10


@pytest.fixture(autouse=True)
def one_blas_thread():
    """numpy's BLAS on one thread, as tests/torch_threads.py sets
    PyTorch's: its default of a thread per core in each of the suite's
    worker processes oversubscribes the cores (the r_RF test took 18.8 s
    beside seven busy processes against 1.9 s on one thread)."""
    with threadpool_limits(1):
        yield


def native_golden(h, vp, vs, rho):
    return native.surfdisp_native(h, vp, vs, rho, gates.WALK_PERIODS,
                                  iwave=2)


@pytest.fixture(scope='module')
def sampler():
    return gates.pin_sampler('cpu')


def test_dim_reject_pin_bands(sampler):
    r = gates.dim_reject_pin(sampler)
    print(r)
    assert r['proposed'] == 4 * gates.PIN_CHAINS
    assert r['birth'] <= 10.0, r
    assert 12.0 <= r['death'] <= 33.0, r
    assert 5.0 <= r['combined'] <= 17.0, r
    assert r['ok']


def test_converged_dim_reject_band(sampler):
    r = gates.converged_band(sampler)
    print(r)
    assert r['chains'] == 21 * gates.CONVERGED_REPS
    assert 6.0 < r['rate'] < 22.0, r
    assert r['ok']


def test_port_float64_cold_solve_matches_native_golden():
    rows = []

    def both(h, vp, vs, rho):
        cg_n, err_n = native_golden(h, vp, vs, rho)
        rows.append((cg_n, err_n) + gates.cold_golden(h, vp, vs, rho))
        return cg_n, err_n

    kept = sum(len(c[2]) for c in gates.walker_cases(both))
    assert kept == len(gates.WALK_KINDS) * gates.WALK_MODELS
    assert all(err_n == err_p for _, err_n, _, err_p in rows)
    d = np.concatenate([np.abs(cg_n - cg_p) for cg_n, err_n, cg_p, _ in rows
                        if not err_n])
    print('models', len(rows), 'lanes', d.size, 'max |port f64 - native|',
          d.max(), 'lanes beyond 1e-10', int((d > GOLDEN_CLOSE).sum()))
    assert d.max() < GOLDEN_TOL
    assert (d > GOLDEN_CLOSE).sum() <= 0.01 * d.size


@pytest.mark.parametrize('golden', ['native', 'port_float64'])
def test_walker_warm_error_against_float64_golden(golden):
    r = gates.walker_golden('cpu', native_golden if golden == 'native'
                            else gates.cold_golden)
    print(golden, r)
    assert r['lanes'] >= 250
    assert r['median'] < 2e-6 and r['p99'] < 2e-5
    assert r['outliers'] <= 0.01 * (r['lanes'] + r['outliers'])
    assert r['ok']
