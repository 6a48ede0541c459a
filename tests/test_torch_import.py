"""The PyTorch port imports without JAX (the forward plugins, the
linearized RF inversion ``ops/rf_pd.py``, ``utils``, the templates
``templates/myfwd.py`` and ``templates/mytarget.py``, parallel tempering
``sampler/tempering.py``, ``parallel/tomo.py``, ``models``, the
post-processing ``plotting`` and the live monitor ``baywatch``
included), without matplotlib and without zmq, the reference's public
names all resolve to the port's classes, its kernel wrappers run their plain twins — launching
nothing — for CPU tensors (the unflattened RF forward and the solver
options among them), the six-target spherical configuration, a tempered
sweep and ``SynthObs``'s dispersion data run on the CPU, and an
inversion through ``MCMC_Optimizer`` on the CPU and
``PlotFromStorage.save_final_distribution`` on its files import nothing
of JAX, matplotlib or zmq either; nor do the sampler gates (``gates``)
and the tutorial scripts' counterparts (``tutorial/*_torch.py``)."""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import sys
import numpy as np
import torch
import bayhunter_tpu_torch
from bayhunter_tpu_torch import bench_config, convert
from bayhunter_tpu_torch.ops import _ext, prep, resp, rf, walk, swd
from bayhunter_tpu_torch.sampler.chain import dispatch_cycles
from bayhunter_tpu_torch import (config, diagnostics, optimizer, synthobs,
                                 utils, MCMC_Optimizer, Targets)
from bayhunter_tpu_torch.forward import SurfDisp, SynRF
from bayhunter_tpu_torch.forward import rf_plugin, swd_plugin
from bayhunter_tpu_torch.ops import rf_pd
from bayhunter_tpu_torch.templates import myfwd
from bayhunter_tpu_torch import SynthObs, diagnostics as diag
from bayhunter_tpu_torch.sampler import tempering
from bayhunter_tpu_torch.parallel import TomoInversion, tomo
from bayhunter_tpu_torch import baywatch, models, plotting
from bayhunter_tpu_torch.templates import mytarget
from bayhunter_tpu_torch.sampler import chain
from bayhunter_tpu_torch import gates
sys.path.insert(0, 'tutorial')
import create_testdata_torch, estimate_rRF_torch, tutorialhunt_torch
for name, (mod, cls) in {
        'Model': (models, 'Model'), 'ModelMatrix': (models, 'ModelMatrix'),
        'SingleChain': (chain, 'SingleChain'),
        'PlotFromStorage': (plotting, 'PlotFromStorage'),
        'BayWatcher': (baywatch, 'BayWatcher')}.items():
    assert getattr(bayhunter_tpu_torch, name) is getattr(mod, cls), name
assert bayhunter_tpu_torch.parallel.TomoInversion is TomoInversion
assert bayhunter_tpu_torch.sampler.tempering is tempering
assert 'jax' not in sys.modules, 'jax imported'
assert 'bayhunter_tpu' not in sys.modules, 'the JAX package imported'
assert 'triton' not in sys.modules, 'triton imported'
assert 'matplotlib' not in sys.modules, 'matplotlib imported'
assert 'zmq' not in sys.modules, 'zmq imported'

for build in (bench_config.build, bench_config.build_rl_prf,
              bench_config.build_prf_srf, bench_config.build_six_sph):
    sampler, ev = build('cpu', iters=20)
    states, gen = sampler.init_states_host(0, 4)
    states = dispatch_cycles(sampler, states, -20, 5, gen)
    states = dispatch_cycles(sampler, states, -15, 5, gen)
    assert int(states.proposed[:, 2].sum()) > 0, 'no dimension step ran'
    assert bool(torch.isfinite(states.logL).all())
assert len(states.cache) == 6
# tempered sweeps on the CPU
sampler, _ = bench_config.build('cpu', iters=20)
sampler, plan = tempering.attach(sampler, 4, 2, 10.0)
states, gen = sampler.init_states_host(0, 4, betas=plan.betas)
# an early cycle and a late one: sweeps of parity 1 (no pair of two
# rungs) and 0 (one pair in each of the two groups)
states = dispatch_cycles(sampler, states, -20, 8, gen)
assert int(states.swap_proposed.sum()) == 2
data = synthobs.SynthObs.return_swddata([5., 23., 0.], [2.7, 3.6, 4.4],
                                        x=np.linspace(1, 41, 5),
                                        device='cpu')
assert sorted(data) == ['ldispgr', 'ldispph', 'rdispgr', 'rdispph']
assert all(np.all(np.isfinite(v)) for v in data.values())
layers = [np.tile(np.array([[3.0, 0.0, 0.0]], np.float32), (2, 1))]
layers += [np.tile(np.array([[v, 1.2 * v, 1.2 * v]], np.float32), (2, 1))
           for v in (5.0, 2.9, 2.4)]
q = np.full((2, 3), 300.0, np.float32)
for qp, qs in ((500.0, 225.0), (2.25 * q, q)):
    y = rf.synrf_batch(*layers, qp, qs, 6.4, 1.0, 64, 5.0, 2.0,
                       layers[2][:, 0], 0.25, wave_type=rf.SV_WAVE,
                       device='cpu')
    assert y.shape == (2, 64) and bool(torch.isfinite(y).all())
y = rf.synrf_batch(*layers, 500.0, 225.0, 6.4, 1.0, 64, 5.0, 2.0,
                   layers[2][:, 0], 0.25, flattening=False, device='cpu')
assert bool(torch.isfinite(y).all())
for options in range(4):
    out = rf.synrf(*(x[0] for x in layers), 500.0, 225.0, 6.4, 1.0, 64,
                   5.0, 2.0, 2.9, 0.25, options=options, device='cpu')
    assert all(bool(torch.isfinite(t).all()) for t in out)
rf_win, J = rf_pd.rf_partials(*(torch.tensor(x[0]) for x in layers[:3]),
                              500.0, 225.0, 6.4, 1.0, 64, 5.0, 2.0, 2.9,
                              0.25)
assert J.shape == (64, 3) and bool(torch.isfinite(J).all())
x, y = myfwd.MyForwardModel(np.arange(3.0), 'mine').run_model(
    [3.0, 0.0], [5.0, 6.0], [2.9, 3.5], [2.4, 2.7])
assert y.shape == (3,) and np.allclose(y, 3.2)
counts = (prep.model_operands.launches, walk.warm_roots_walk.launches,
          resp.resp.launches, resp.resp_q.launches, swd.secular4.launches,
          swd.secular1.launches, prep.rf_operands.launches)
assert counts == (0,) * 7, counts
assert _ext._Build.lib is None, 'the kernel library was loaded'

# an inversion of a few iterations, vp/vs inverted, the mantle prior
import os, tempfile
obs = np.loadtxt(os.path.join(bench_config.FIXTURES, 'st3_rdispph.dat'))
joint = Targets.JointTarget([Targets.RayleighDispersionPhase(
    obs[:, 0], obs[:, 1])])
with tempfile.TemporaryDirectory() as tmp:
    opt = MCMC_Optimizer(joint, {'nchains': 3, 'iter_burnin': 6,
                                 'iter_main': 6, 'savepath': tmp},
                         {'layers': (1, 7), 'mantle': (4.1, 1.8)},
                         random_seed=1, device='cpu')
    opt.mp_inversion()
    assert len(os.listdir(os.path.join(tmp, 'data'))) == 3 * 2 * 5 + 1
    post = bayhunter_tpu_torch.PlotFromStorage(
        os.path.join(tmp, 'data', 'test_config.pkl'), device='cpu')
    post.save_final_distribution(maxmodels=100, dev=0.05)
    models = np.load(os.path.join(tmp, 'data', 'c_models.npy'))
    assert models.shape[1] == 2 * 8 and len(models) > 0
assert prep.model_operands.launches == 0

assert 'jax' not in sys.modules
assert 'bayhunter_tpu' not in sys.modules
assert 'matplotlib' not in sys.modules
assert 'zmq' not in sys.modules
print('OK')
'''


def test_port_imports_without_jax_and_launches_nothing_on_cpu():
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    env['OMP_NUM_THREADS'] = '1'      # as tests/torch_threads.py sets
    r = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith('OK')
