"""float64 inversions through the port's entry points, on the CPU.

``MCMC_Optimizer(..., dtype=torch.float64)`` and
``TomoInversion(..., dtype=torch.float64)`` build their evaluator
without the batch path (the JAX rule: the batch path is float32 only),
so every warm step runs the per-chain ring path (``Evaluator.eval_full``)
on float64 states; a float32 run keeps the batch path.  Held here: the
``.npy`` files stay float32 (``bayhunter_tpu/optimizer.py:422-425``), a
float64 run resumes from its checkpoint bit for bit, and a split over
two workers builds each worker's sampler at the parent's dtype and
equals the one-device run.  ``tests/test_torch_ring_path.py`` holds the
ring path's numbers to the JAX package's.
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from bayhunter_tpu_torch import MCMC_Optimizer, bench_config  # noqa: E402
from bayhunter_tpu_torch.ops import swd  # noqa: E402
from bayhunter_tpu_torch.parallel import TomoInversion  # noqa: E402
from bayhunter_tpu_torch.sampler.evaluator import build_evaluator  # noqa: E402

F64 = torch.float64


def _tutorial(path, **ip):
    """The tutorial's data and priors at 8 layer slots, 8 chains, 16 +
    8 iterations, maxmodels 8, the segment pinned at 4."""
    targets, _ = bench_config.tutorial_targets()
    priors, params = bench_config.tutorial_params()
    priors['layers'] = (1, 7)
    params.update(nchains=8, iter_burnin=16, iter_main=8, maxmodels=8,
                  segment_iters=4, checkpoint_seconds=0, savepath=str(path))
    params.update(ip)
    return targets, priors, params


def test_dtype_picks_the_path():
    targets, priors, ip = _tutorial(None)
    one = MCMC_Optimizer.without_files(targets, ip, priors, 1, device='cpu')
    two = MCMC_Optimizer.without_files(targets, ip, priors, 1, dtype=F64,
                                       device='cpu')
    assert one.eval_fn.batch and one.eval_fn.dtype == torch.float32
    assert not two.eval_fn.batch and two.eval_fn.dtype == F64
    assert two.cfg.dtype == F64 == two.sampler.dtype
    with pytest.raises(ValueError, match='float32 only'):
        build_evaluator(targets, bench_config.PRIORS,
                        bench_config.initparams(10), 8, 'cpu', F64)


def test_float64_run_writes_float32_files_and_resumes_bitwise(tmp_path):
    targets, priors, ip = _tutorial(tmp_path / 'one')
    base = MCMC_Optimizer(targets, ip, priors, random_seed=4, dtype=F64,
                          device='cpu')
    base.mp_inversion()
    st = base.final_states
    assert st.vs.dtype == st.logL.dtype == st.cache[1][0].dtype == F64
    assert bool(torch.isfinite(st.logL).all())
    assert int(st.proposed[:, 2].sum()) > 0
    for name in ('c000_p1models', 'c007_p2likes', 'c003_p2noise'):
        assert np.load(os.path.join(base.savepath, name + '.npy')).dtype \
            == np.float32

    class Stopped(Exception):
        pass

    class StopsAtSecond(MCMC_Optimizer):
        written = 0

        def save_checkpoint(self, *a, **kw):
            super().save_checkpoint(*a, **kw)
            StopsAtSecond.written += 1
            if StopsAtSecond.written == 2:
                raise Stopped

    ip2 = dict(ip, checkpoint_seconds=1e-9, savepath=str(tmp_path / 'two'))
    with pytest.raises(Stopped):
        StopsAtSecond(targets, ip2, priors, random_seed=4, dtype=F64,
                      device='cpu').mp_inversion()
    with np.load(tmp_path / 'two' / 'data' / 'checkpoint.npz') as ck:
        assert (int(ck['phase']), int(ck['it_done'])) == (1, 8)
        assert ck['state_vs'].dtype == np.float64
    again = MCMC_Optimizer(targets, ip2, priors, random_seed=4, dtype=F64,
                           device='cpu')
    again.mp_inversion(resume=True)
    assert chip_smoke.same_outputs(base.savepath, again.savepath)
    assert chip_smoke.same_states(torch, base.final_states,
                                  again.final_states)


def test_float64_split_equals_the_one_device_run():
    targets, priors, ip = _tutorial(None, nchains=2, iter_burnin=4,
                                    iter_main=4, resort_chains=False)
    runs = []
    for where in (dict(device='cpu'), dict(devices=['cpu', 'cpu'])):
        opt = MCMC_Optimizer.without_files(targets, ip, priors, 6,
                                           dtype=F64, **where)
        opt.mp_inversion()
        runs.append(opt)
    one, split = runs
    assert split.final_states.vs.dtype == F64
    assert chip_smoke.same_states(torch, one.final_states,
                                  split.final_states)
    for tag in ('p1', 'p2'):
        for key, x in one.snapshots[tag].items():
            assert np.array_equal(x, split.snapshots[tag][key],
                                  equal_nan=True), (tag, key)


def test_float64_tomography_on_two_cells():
    x = np.linspace(2.0, 40.0, 8)
    h, vs = np.array([5.0, 23.0, 8.0, 0.0]), np.array([2.7, 3.6, 3.8, 4.4])
    curve, _ = swd.surfdisp(h, vs * 1.73, vs, vs * 1.73 * 0.32 + 0.77, x,
                            device='cpu')
    Y = np.stack([curve.numpy(), curve.numpy() * 1.01])
    tomo = TomoInversion(x, Y, chains_per_cell=4,
                         priors={'layers': (1, 5)},
                         initparams={'iter_burnin': 16, 'iter_main': 8},
                         random_seed=3, dtype=F64, device='cpu')
    assert not tomo.eval_fn.batch
    out = tomo.run(segment_iters=8)
    st = tomo.final_states
    assert st.vs.dtype == st.cache[0][1].dtype == F64
    assert out['vs_median'].shape == (2, 121)
    assert np.isfinite(out['vs_median']).all()
    assert bool(torch.isfinite(st.logL).all())
