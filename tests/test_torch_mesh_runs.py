"""``MCMC_Optimizer`` and ``TomoInversion`` split over spawned CPU
workers (``devices=['cpu'] * n``) against their one-device runs:

  * (d) ``tests/test_sharding8.py:95``'s optimizer (Rayleigh phase with
    noise, 8 chains, 200 + 200 iterations, maxmodels 20) over two
    workers, its segment pinned: with ``resort_chains`` off, a split run
    stopped at its last checkpoint of the main phase has written the
    burn-in files of the one-device run byte for byte, and resumed split
    it writes all of them and ends in its final states; the same
    checkpoint resumed on one device gives the same files; with the
    resort on (40 + 40 iterations), ``:95``'s contract (every chain's
    files, finite likes) and the sort within each block;
  * (f) ``TomoInversion`` of 4 cells x 8 chains over two workers: the
    final states and every array of the summary equal the one-device
    run's bit for bit (20 + 10 iterations in segments of 10);
  * (h) on a card (marker ``cuda``, skipped without one): the tiny
    problem of ``tests/test_torch_mesh.py`` (c) over two workers on
    ``cuda:0``, equal to the run in this process on the card.

The file imports no jax, so that the card's machine runs (h):
``python -m pytest --noconftest tests/test_torch_mesh_runs.py -m cuda``.

Each split run starts its workers and joins them before it returns.
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import torch_mesh_workers as tmw  # noqa: E402
from bayhunter_tpu_torch import (MCMC_Optimizer, Targets,  # noqa: E402
                                 bench_config)
from bayhunter_tpu_torch.parallel import TomoInversion, mesh  # noqa: E402
from bayhunter_tpu_torch.synthobs import SynthObs  # noqa: E402

CPUS = ['cpu', 'cpu']
SEGMENT = 50


def _joint():
    """``:95``'s data: the tutorial's 4-layer model's Rayleigh phase
    velocities with noise of sigma 0.012 from RandomState(3)."""
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73,
                                   device='cpu')['rdispph']
    rs = np.random.RandomState(3)
    ynoisy = np.asarray(y) + 0.012 * rs.normal(size=np.asarray(y).size)
    return Targets.JointTarget(targets=[
        Targets.RayleighDispersionPhase(np.asarray(x), ynoisy)])


def _optimizer(path, cls=MCMC_Optimizer, **kw):
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 8),
              'vpvs': 1.73, 'swdnoise_corr': 0.0,
              'swdnoise_sigma': (1e-5, 0.05)}
    ip = {'nchains': 8, 'iter_burnin': 200, 'iter_main': 200,
          'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
          'acceptance': (40, 45), 'thickmin': 0.1,
          'maxmodels': 20, 'savepath': str(path), 'station': 'mesh8',
          'segment_iters': SEGMENT, 'checkpoint_seconds': 0,
          'resort_chains': False}
    ip.update(kw.pop('ip', {}))
    return cls(_joint(), ip, priors, random_seed=9, **kw)


class Stopped(Exception):
    pass


class StopsAtLast(MCMC_Optimizer):
    """Stops right after its checkpoint of the main phase's last
    segment but one, as a lost process would."""

    def save_checkpoint(self, states, phase, it_done, parts, segment):
        super().save_checkpoint(states, phase, it_done, parts, segment)
        if (phase, it_done) == (2, self.iter_phase2 - SEGMENT):
            raise Stopped


def _files(path, tag=''):
    return sorted(f for f in os.listdir(path)
                  if f.endswith('.npy') and tag in f)


def _same_files(a, b, tag=''):
    names = _files(a, tag)
    assert names == _files(b, tag) and names
    for f in names:
        with open(os.path.join(a, f), 'rb') as fa, \
                open(os.path.join(b, f), 'rb') as fb:
            assert fa.read() == fb.read(), f


def test_optimizer_split_equals_one_device_and_resumes(tmp_path):
    one = _optimizer(tmp_path / 'one', device='cpu')
    one.mp_inversion()

    ckpt = tmp_path / 'stopped' / 'data' / 'checkpoint.npz'
    stopped = _optimizer(tmp_path / 'stopped', cls=StopsAtLast,
                         devices=CPUS, ip={'checkpoint_seconds': 1e-9})
    with pytest.raises(Stopped):
        stopped.mp_inversion()
    # the workers are gone, the burn-in files are the one-device run's
    assert stopped._pool is None
    _same_files(one.savepath, stopped.savepath, 'p1')
    assert not _files(stopped.savepath, 'p2')
    os.makedirs(tmp_path / 'on_one' / 'data')
    shutil.copy(ckpt, tmp_path / 'on_one' / 'data')

    # resumed split: every file and the final states
    again = _optimizer(tmp_path / 'stopped', devices=CPUS)
    again.mp_inversion(resume=True)
    _same_files(one.savepath, again.savepath)
    assert chip_smoke.same_states(torch, one.final_states,
                                  again.final_states)
    assert not os.path.exists(ckpt)
    reports = again.worker_reports
    assert [r['rows'] for r in reports] == [(0, 4), (4, 8)]
    assert [r['device'] for r in reports] == CPUS

    # the split checkpoint resumed on one device
    single = _optimizer(tmp_path / 'on_one', device='cpu')
    single.mp_inversion(resume=True)
    _same_files(one.savepath, single.savepath, 'p2')


def test_optimizer_split_with_resort(tmp_path):
    # 40 + 40 iterations (thin 2): the contract's, at a fifth of the
    # cost
    opt = _optimizer(tmp_path, devices=CPUS, ip={
        'resort_chains': True, 'iter_burnin': 40, 'iter_main': 40})
    opt.mp_inversion()
    datadir = os.path.join(str(tmp_path), 'data')
    assert chip_smoke.check_contract(opt) == {'p1': 20, 'p2': 20}
    likes = np.load(os.path.join(datadir, 'c000_p2likes.npy'))
    assert likes.size > 0 and np.all(np.isfinite(likes))
    # each worker sorted its own rows, which hold its own chains
    perm = opt._perm.numpy()
    n = opt.final_states.n.numpy()
    for a, b in ((0, 4), (4, 8)):
        assert sorted(perm[a:b]) == list(range(a, b))
        assert np.all(np.diff(n[a:b]) >= 0)
    # the snapshots' last logL is each chain's final one
    last = [np.load(os.path.join(datadir, 'c%.3d_p2likes.npy' % c))[-1]
            for c in range(8)]
    np.testing.assert_array_equal(
        last, opt.final_states.logL.numpy()[np.argsort(perm)])


def test_tomo_split_equals_one_device():
    x, Y = bench_config.tomo_data(ncells=4, seed=0, device='cpu')
    kw = dict(ref='rdispph', chains_per_cell=8,
              priors={'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 6),
                      'vpvs': 1.73, 'swdnoise_corr': 0.0,
                      'swdnoise_sigma': (1e-4, 0.05)},
              initparams={'iter_burnin': 20, 'iter_main': 10,
                          'propdist': (0.03, 0.03, 0.015, 0.005, 0.005),
                          'acceptance': (40, 45), 'thickmin': 0.1},
              random_seed=5)
    one = TomoInversion(x, Y, device='cpu', **kw)
    want = one.run(segment_iters=10)
    split = TomoInversion(x, Y, devices=CPUS, **kw)
    got = split.run(segment_iters=10)
    assert chip_smoke.same_states(torch, one.final_states,
                                  split.final_states)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert [r['rows'] for r in split.worker_reports] == [(0, 16), (16, 32)]
    assert [p[0] for p in split.progress] == [p[0] for p in one.progress]


@pytest.mark.cuda
def test_tiny_split_two_workers_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    from bayhunter_tpu_torch.ops import _ext
    _ext.load()
    want = tmw.in_process(16, device='cuda:0')
    devs = ['cuda:0', 'cuda:0']
    with mesh.Workers(devs, mesh.chain_sharding(16, devs),
                      tmw.TinyRun) as pool:
        got = tmw.split(pool, 16)
    tmw.assert_same(got, want)
