"""The PyTorch port imports without JAX, and its kernel wrappers run
their plain twins — launching nothing — for CPU tensors."""

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
assert 'jax' not in sys.modules, 'jax imported'
assert 'bayhunter_tpu' not in sys.modules, 'the JAX package imported'
assert 'triton' not in sys.modules, 'triton imported'

for build in (bench_config.build, bench_config.build_rl_prf,
              bench_config.build_prf_srf):
    sampler, ev = build('cpu', iters=20)
    states, gen = sampler.init_states_host(0, 4)
    states = dispatch_cycles(sampler, states, -20, 5, gen)
    states = dispatch_cycles(sampler, states, -15, 5, gen)
    assert int(states.proposed[:, 2].sum()) > 0, 'no dimension step ran'
    assert bool(torch.isfinite(states.logL).all())
assert len(states.cache) == 3
layers = [np.tile(np.array([[3.0, 0.0, 0.0]], np.float32), (2, 1))]
layers += [np.tile(np.array([[v, 1.2 * v, 1.2 * v]], np.float32), (2, 1))
           for v in (5.0, 2.9, 2.4)]
q = np.full((2, 3), 300.0, np.float32)
for qp, qs in ((500.0, 225.0), (2.25 * q, q)):
    y = rf.synrf_batch(*layers, qp, qs, 6.4, 1.0, 64, 5.0, 2.0,
                       layers[2][:, 0], 0.25, wave_type=rf.SV_WAVE,
                       device='cpu')
    assert y.shape == (2, 64) and bool(torch.isfinite(y).all())
counts = (prep.model_operands.launches, walk.warm_roots_walk.launches,
          resp.resp.launches, resp.resp_q.launches, swd.secular4.launches,
          swd.secular1.launches, prep.rf_operands.launches)
assert counts == (0,) * 7, counts
assert _ext._Build.lib is None, 'the kernel library was loaded'

assert 'jax' not in sys.modules
print('OK')
'''


def test_port_imports_without_jax_and_launches_nothing_on_cpu():
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith('OK')
