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
from bayhunter_tpu_torch.ops import _ext, prep, resp, walk, swd
from bayhunter_tpu_torch.sampler.chain import dispatch_cycles
assert 'jax' not in sys.modules, 'jax imported'
assert 'bayhunter_tpu' not in sys.modules, 'the JAX package imported'
assert 'triton' not in sys.modules, 'triton imported'

for build in (bench_config.build, bench_config.build_rl_prf):
    sampler, ev = build('cpu', iters=20)
    states, gen = sampler.init_states_host(0, 4)
    states = dispatch_cycles(sampler, states, -20, 5, gen)
    states = dispatch_cycles(sampler, states, -15, 5, gen)
    assert int(states.proposed[:, 2].sum()) > 0, 'no dimension step ran'
    assert bool(torch.isfinite(states.logL).all())
assert len(states.cache) == 3
counts = (prep.model_operands.launches, walk.warm_roots_walk.launches,
          resp.resp.launches, swd.secular4.launches,
          swd.secular1.launches, prep.rf_operands.launches)
assert counts == (0,) * 6, counts
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
