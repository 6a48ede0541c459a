"""What the split tests' spawned workers import: the tiny SWD-only
problem of ``tests/test_sharding8.py:32-53`` in the port, and
:class:`TinyRun`, the object a worker of ``mesh.Workers`` builds on its
device and rows.  It imports torch and the port alone (no jax), so that
a worker starts without the JAX package."""

import time

import numpy as np

from bayhunter_tpu_torch import Targets, convert
from bayhunter_tpu_torch.parallel import mesh
from bayhunter_tpu_torch.sampler import tempering
from bayhunter_tpu_torch.sampler.chain import (Sampler, dispatch_cycles,
                                               make_config)
from bayhunter_tpu_torch.sampler.evaluator import build_evaluator
from bayhunter_tpu_torch.synthobs import SynthObs

NL = 6
PRIORS = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, NL - 1),
          'vpvs': 1.73, 'swdnoise_corr': 0.0,
          'swdnoise_sigma': (1e-5, 0.05)}
INITPARAMS = {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
              'acceptance': (40, 45), 'thickmin': 0.1,
              'iter_burnin': 512, 'iter_main': 512}


def tiny_targets():
    """``_tiny_sampler``'s targets: Rayleigh phase at 8 periods of the
    tutorial's 4-layer model."""
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73,
                                   x=np.linspace(2., 30., 8),
                                   device='cpu')['rdispph']
    return Targets.JointTarget(targets=[
        Targets.RayleighDispersionPhase(np.asarray(x), np.asarray(y))])


def tiny_sampler(device):
    """The port's sampler of ``_tiny_sampler``: :func:`tiny_targets`, 6
    layer slots."""
    joint = tiny_targets()
    cfg = make_config(PRIORS, INITPARAMS, ['swd'], nl=NL)
    ev = build_evaluator(joint, PRIORS, INITPARAMS, NL, device)
    return Sampler(ev, cfg, device)


def segment(sampler):
    """(first iteration, count) of ``_run_cycles_from``'s segment: one
    early cycle before the early cutoff, a remainder, three late cycles
    and a remainder."""
    early, late = len(sampler.early_order), len(sampler.late_order)
    return int(sampler.early_cutoff) - early - 1, 1 + early + 3 * late + 2


class TinyRun(object):
    """The tiny problem on ``device`` for ``rows`` of the batch (all of
    it for None); the methods are ``mesh.Workers`` block operations."""

    def __init__(self, device, rows=None):
        self.sampler = tiny_sampler(device)
        self.sampler.rows = rows

    def init(self, states, seed, nchains, ntemps=1):
        """Initial states of ``nchains`` chains from ``seed``, with
        ``ntemps`` rungs of replica exchange (tmax 10, a sweep after
        every cycle) when above one."""
        self.sampler.swap_fn, self.sampler.swap_every = None, 0
        betas = None
        if ntemps > 1:
            _, plan = tempering.attach(self.sampler, nchains, ntemps,
                                       tmax=10.0, swap_every=1)
            betas = plan.betas
        states, self.gen = self.sampler.init_states_host(seed, nchains,
                                                         betas=betas)
        return states, None

    def cycles(self, states):
        it, count = segment(self.sampler)
        return dispatch_cycles(self.sampler, states, it, count,
                               self.gen), None

    def state(self, states):
        return states, convert.state_to_numpy(states)


def in_process(nchains, ntemps=1, device='cpu'):
    """The segment of :meth:`TinyRun.cycles` from seed 0 in this
    process: the final states' fields as numpy."""
    run = TinyRun(device)
    states, _ = run.init(None, 0, nchains, ntemps)
    states, _ = run.cycles(states)
    return run.state(states)[1]


def split(pool, nchains, ntemps=1):
    """The same over the workers of ``pool`` (``mesh.Workers`` of
    :class:`TinyRun`), gathered."""
    pool.call('init', 0, nchains, ntemps)
    pool.call('cycles')
    return mesh.concat(pool.call('state'))


def assert_same(a, b):
    """Every field of two states' numpy fields equal bit for bit."""
    for key in convert.FLOAT_FIELDS + convert.INT_FIELDS:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for ea, eb in zip(a['cache'], b['cache']):
        for x, y in zip(ea, eb):
            np.testing.assert_array_equal(x, y)


def raises(message):
    raise ValueError(message)


def slow_build(device, rows):
    time.sleep(60)
