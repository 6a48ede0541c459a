"""Tomography-scale batched inversions: many independent datasets
("cells" of a velocity map) times many chains each, as one batch.

Mirrors ``bayhunter_tpu/parallel/tomo.py``.  A (ncells, ndata)
observation matrix rides the chain axis: each chain carries a ``cell``
index that selects its observed row (``sampler/evaluator.py``
``yobs_for``), so a 1,000-cell x 100-chain ambient-noise map is one
100,000-chain batch.  ``devices`` splits the batch over several
devices, one spawned worker per entry (``parallel/mesh.py``), as the JAX
package shards it over a mesh: the cells ride on their chains' rows,
each worker runs the segments of its block, and the summary is computed
here on the gathered final states, which equal the one-device run's bit
for bit.  Without padding: the blocks are as even as the chains allow.

Kernels on the path: the cold evaluation runs K4 (Rayleigh) or K5
(Love) in its counting search, chunk by chunk; each step runs K1 (the
dispersion set) and K2.
"""

import logging
import time

import numpy as np
import torch

from bayhunter_tpu_torch import Targets
from bayhunter_tpu_torch import config as cfgio
from bayhunter_tpu_torch import convert, ops
from bayhunter_tpu_torch.parallel import mesh
from bayhunter_tpu_torch.sampler.chain import (Sampler, dispatch_cycles,
                                               make_config)
from bayhunter_tpu_torch.sampler.evaluator import build_evaluator

logger = logging.getLogger(__name__)

TARGET_CLASSES = {
    'rdispph': Targets.RayleighDispersionPhase,
    'rdispgr': Targets.RayleighDispersionGroup,
    'ldispph': Targets.LoveDispersionPhase,
    'ldispgr': Targets.LoveDispersionGroup,
}
DEPTHS = 121            # the summary's regular depth grid over the z prior
SUMMARY_CHUNK = 4096    # chains per block of the vectorised summary


class TomoInversion(object):
    """Joint inversion of ``ncells`` independent dispersion curves.

    Parameters
    ----------
    x : (ndata,) periods
    Y : (ncells, ndata) observed dispersion matrix
    ref : one of rdispph / rdispgr / ldispph / ldispgr
    chains_per_cell : chains allocated to every cell
    priors / initparams : reference-style dicts (defaults.ini filled in)
    dtype : the chains' floating type: float32 (the batch path) or
        float64 (the per-chain ring path, the kernels' double instances)
    device : a CUDA device unless given (``'cpu'`` runs the twins)
    devices : a list of devices, one worker each (``parallel/mesh.py``);
        with neither given, every visible CUDA device
    """

    def __init__(self, x, Y, ref='rdispph', chains_per_cell=32,
                 priors=None, initparams=None, random_seed=None,
                 dtype=torch.float32, device=None, devices=None):
        self.device, self.devices = mesh.resolve_devices(
            device, devices, 'TomoInversion')
        self.x = np.asarray(x, float)
        Y = np.atleast_2d(np.asarray(Y, float))
        self.Y = Y
        self.ncells = Y.shape[0]
        self.chains_per_cell = int(chains_per_cell)

        self.priors, self.initparams = cfgio.load_params(
            cfgio.get_path('defaults.ini'))
        self.priors.update(priors or {})
        self.initparams.update(initparams or {})

        target = TARGET_CLASSES[ref](np.asarray(x, float), Y)
        self.joint = Targets.JointTarget(targets=[target])

        self.ref = ref
        nl = int(self.priors['layers'][1]) + 1
        self.dtype = dtype
        self.cfg = make_config(self.priors, self.initparams, ['swd'], nl=nl,
                               dtype=dtype)
        self.nchains = self.ncells * self.chains_per_cell
        self.seed = (random_seed if random_seed is not None
                     else np.random.RandomState().randint(2 ** 31))
        # a split run's workers evaluate; this process summarises
        self.eval_fn = self.sampler = self.blocks = None
        self.worker_reports = self.pool_stats = None
        self._gen = self._launches_at_init = None
        if self.devices:
            self.blocks = mesh.chain_sharding(self.nchains, self.devices)
        else:
            self.eval_fn = build_evaluator(
                self.joint, self.priors, self.initparams, nl, self.device,
                dtype, use_batch_swd=dtype == torch.float32)
            self.sampler = Sampler(self.eval_fn, self.cfg, self.device)

    def run(self, segment_iters=200, log_every=5):
        """Run burn-in + main over all cells; returns the per-cell
        posterior summary of :meth:`summarize`.  Every ``log_every``-th
        segment the chains are synchronised and (iterations done,
        seconds since the start) is logged and appended to
        ``self.progress``.  A split run's workers are closed before this
        returns, their reports in ``worker_reports``."""
        if not self.devices:
            states = self._run(None, segment_iters, log_every)
        else:
            if any(d.type == 'cuda' for d in self.devices):
                from bayhunter_tpu_torch.ops import _ext
                _ext.load()
            with mesh.Workers(self.devices, self.blocks, _worker_tomo, (
                    self.x, self.Y, self.ref, self.chains_per_cell,
                    self.priors, self.initparams, self.seed,
                    self.dtype)) as pool:
                states = self._run(pool, segment_iters, log_every)
            self.worker_reports, self.pool_stats = pool.reports, pool.stats()
            for rep, at_init in zip(pool.reports, self._launches_at_init):
                rep['launches_at_init'] = at_init
        self.final_states = states
        return self.summarize(states)

    def _blocks(self, states, name, *args):
        """Run the block operation ``name`` on this process's chains
        (``states``) or in every worker (``states`` is then the pool);
        returns (states, [each block's output on the host])."""
        if isinstance(states, mesh.Workers):
            return states, states.call(name, *args)
        states, out = getattr(self, name)(states, *args)
        return states, [mesh.to_host(out)]

    def _run(self, states, segment_iters, log_every):
        """The segments of :meth:`run` on this process's chains (from
        ``states`` None) or on the workers of the pool ``states``;
        returns the final states (a split's gathered on the CPU)."""
        states = self._blocks(states, '_block_init')[0]
        split = isinstance(states, mesh.Workers)
        if split:
            self._launches_at_init = states.each(ops.launch_counts)
        total = (int(self.initparams['iter_burnin'])
                 + int(self.initparams['iter_main']))
        t0 = time.time()
        self.progress = []
        done = 0
        seg_i = 0
        it_global = -int(self.initparams['iter_burnin'])
        while done < total:
            k = min(segment_iters, total - done)
            states = self._blocks(states, '_block_run', it_global, k)[0]
            done += k
            it_global += k
            seg_i += 1
            if seg_i % log_every == 0 or done >= total:
                logL = mesh.concat(self._blocks(states, '_block_logL')[1])
                self.progress.append((done, time.time() - t0))
                rate = done * self.nchains / self.progress[-1][1]
                logger.info('tomo %7d/%d it | %.0f proposals/s | logL med '
                            '%.1f' % (done, total, rate,
                                      float(np.median(logL))))
        if not split:
            return states
        return convert.state_from_numpy(
            mesh.concat(states.call('_block_state')), self.device,
            self.dtype)

    # the operations on one block of chains (all of them in this
    # process, a worker's rows in a split run): (states, ...) ->
    # (states, output)

    def _block_init(self, states):
        cells = np.repeat(np.arange(self.ncells), self.chains_per_cell)
        states, self._gen = self.sampler.init_states_host(
            self.seed, self.nchains, cells=cells)
        return states, None

    def _block_run(self, states, it_global, count):
        return dispatch_cycles(self.sampler, states, it_global, count,
                               self._gen), None

    def _block_logL(self, states):
        return states, states.logL

    def _block_state(self, states):
        return states, convert.state_to_numpy(states)

    def summarize(self, states):
        """Per-cell posterior summary from the final chain states: the
        median, mean and spread of each chain's nearest-nucleus vs
        profile (the Voronoi-cell definition, reference:
        src/Models.py:16-52) on ``DEPTHS`` depths over the z prior, and
        the median noise and logL of each cell's chains.  The profiles
        are those of the JAX loop over chains, computed a block of
        chains at a time."""
        vs = states.vs.cpu().numpy()[:self.nchains]
        z = states.z.cpu().numpy()[:self.nchains]
        n = states.n.cpu().numpy()[:self.nchains]
        noise = states.noise.cpu().numpy()[:self.nchains]
        logL = states.logL.cpu().numpy()[:self.nchains]

        zmax = float(self.priors['z'][1])
        dep_int = np.linspace(0.0, zmax, DEPTHS)
        slots = np.arange(z.shape[1])
        prof = np.empty((self.nchains, dep_int.size))
        for a in range(0, self.nchains, SUMMARY_CHUNK):
            b = min(a + SUMMARY_CHUNK, self.nchains)
            # (chains, depths, slots), the slots beyond n out of reach
            dist = np.where(slots[None, None, :] >= n[a:b, None, None],
                            np.inf, np.abs(dep_int[None, :, None]
                                           - z[a:b, None, :].astype(float)))
            idx = dist.argmin(axis=2)
            prof[a:b] = np.take_along_axis(vs[a:b], idx, axis=1)

        prof = prof.reshape(self.ncells, self.chains_per_cell, -1)
        noise_c = noise.reshape(self.ncells, self.chains_per_cell, -1)
        logL_c = logL.reshape(self.ncells, self.chains_per_cell)
        return {
            'depth': dep_int,
            'vs_median': np.median(prof, axis=1),
            'vs_mean': prof.mean(axis=1),
            'vs_std': prof.std(axis=1),
            'noise_median': np.median(noise_c, axis=1),
            'logL_median': np.median(logL_c, axis=1),
        }


def _worker_tomo(device, rows, x, Y, ref, chains_per_cell, priors,
                 initparams, seed, dtype=torch.float32):
    """One worker of a split run: the inversion on ``device`` at the
    parent's ``dtype`` whose sampler runs ``rows`` of the batch
    (``mesh.Workers``)."""
    tomo = TomoInversion(x, Y, ref, chains_per_cell, priors, initparams,
                         seed, dtype=dtype, device=device)
    tomo.sampler.rows = rows
    return tomo
