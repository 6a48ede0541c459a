"""The tutorial scripts' counterparts on the port, on the CPU:

  * ``tutorial/create_testdata_torch.py`` writes the station's data
    equal to the golden fixtures (``tests/fixtures/st3_*.dat``) at the
    golden bounds (1e-4 phase, 5e-4 Rayleigh group, 1e-3 Love group,
    2e-4 P-RF, 1e-4 S-RF; ``chip_smoke.PUBLIC_TOLS``), and the model
    file equal to the fixture's;
  * ``tutorial/tutorialhunt_torch.py`` at 4 chains, 64 + 64 iterations,
    with its figures: the ``.npy`` contract of every chain and phase
    (``chip_smoke.check_contract``), the final posterior arrays and the
    summary PDF;
  * ``tutorial/estimate_rRF_torch.py`` with few draws gives the widths
    of the port's and of the JAX package's ``utils.rrf_estimate`` from
    the same seed.
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import os
import sys

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, 'tests', 'fixtures')
sys.path.insert(0, os.path.join(ROOT, 'tutorial'))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import create_testdata_torch  # noqa: E402
import estimate_rRF_torch  # noqa: E402
import tutorialhunt_torch  # noqa: E402

@pytest.fixture(autouse=True)
def one_blas_thread():
    """numpy's BLAS on one thread, as tests/torch_threads.py sets
    PyTorch's: its default of a thread per core in each of the suite's
    worker processes oversubscribes the cores (the r_RF test took 18.8 s
    beside seven busy processes against 1.9 s on one thread)."""
    with threadpool_limits(1):
        yield


REFS = ('rdispph', 'rdispgr', 'ldispph', 'ldispgr', 'prf', 'srf')


@pytest.fixture(scope='module')
def observed(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('observed'))
    create_testdata_torch.main(path, device='cpu')
    return path


def test_create_testdata_matches_golden_fixtures(observed):
    assert sorted(os.listdir(observed)) == sorted(
        ['st3_%s.dat' % r for r in REFS] + ['st3_mod.dat'])
    for ref in REFS:
        got = np.loadtxt(os.path.join(observed, 'st3_%s.dat' % ref))
        want = np.loadtxt(os.path.join(FIXTURES, 'st3_%s.dat' % ref))
        assert got.shape == want.shape
        assert np.array_equal(got[:, 0], want[:, 0])
        # the files hold 4 decimals: compare in units of the last one
        units = np.rint(np.abs(got[:, 1] - want[:, 1]) * 1e4)
        assert units.max() <= round(chip_smoke.PUBLIC_TOLS[ref] * 1e4), ref
    got = np.loadtxt(os.path.join(observed, 'st3_mod.dat'), skiprows=1)
    want = np.loadtxt(os.path.join(FIXTURES, 'st3_mod.dat'), skiprows=1)
    assert np.array_equal(got, want)


def test_tutorialhunt_runs_with_figures(observed, tmp_path):
    savepath = str(tmp_path / 'results')
    opt, plot = tutorialhunt_torch.main(
        savepath, nchains=4, iter_burnin=64, iter_main=64, random_seed=1,
        device='cpu', plots=True, observed=observed)
    plans = chip_smoke.check_contract(
        opt, chip_smoke.final_files(opt.savepath))
    assert set(plans) == {'p1', 'p2'}
    data = opt.savepath
    models = np.load(os.path.join(data, 'c_models.npy'))
    assert models.shape[1] == 2 * opt.maxlayers
    for ft in ('likes', 'misfits', 'noise', 'vpvs'):
        assert len(np.load(os.path.join(data, 'c_%s.npy' % ft))) \
            == len(models)
    # PlotFromStorage draws its figures beside data/, as the JAX one
    assert os.path.getsize(os.path.join(savepath, 'c_summary.pdf')) > 0
    assert os.path.exists(os.path.join(savepath, 'baywatch.pkl'))


def test_estimate_rrf_matches_both_packages(monkeypatch):
    from bayhunter_tpu import utils as jutils
    from bayhunter_tpu_torch import utils
    rffile = os.path.join(FIXTURES, 'st3_prf.dat')
    pars = {'rfx': np.loadtxt(rffile, usecols=[0]), 'draws': 100,
            'rrfs': estimate_rRF_torch.RRFS}
    monkeypatch.setattr(utils, 'rstate', np.random.RandomState(333))
    rrfs, a_est = estimate_rRF_torch.main(rffile, draws=100)
    for mod in (utils, jutils):
        monkeypatch.setattr(mod, 'rstate', np.random.RandomState(333))
        want = mod.rrf_estimate(pars=pars)
        assert np.array_equal(rrfs, want[0]) and a_est == want[1]
    assert all(np.isfinite(a_est)) and a_est[0] > a_est[-1] > 0
