"""McMC orchestrator: many chains as one batch on one device.

Mirrors ``bayhunter_tpu/optimizer.py`` (the reference ``MCMC_Optimizer``,
src/mcmcOptimizer.py:31-282): the defaults of ``defaults/defaults.ini``
updated by the caller's priors and initparams, the two phases (burn-in
``p1``, main ``p2``) run in segments from the host, snapshots thinned to
at most ``maxmodels`` per phase, the chain resort between segments,
checkpoint and resume, the progress line, the BayWatch publisher and the
reference's on-disk contract: ``c%03d_p{1,2}{models,likes,misfits,
noise,vpvs}.npy`` per chain plus the ``<station>_config.pkl`` pickle
(reference: src/SingleChain.py:665-690, src/mcmcOptimizer.py:52-55).

Snapshots are the states after every ``thin``-th iteration of a phase,
as the JAX package's docstring and the reference say.  (The JAX
``_run_phase`` appends its snapshots after each whole segment, so when
``thin`` is smaller than a segment it records the segment's last state
several times.)  The port dispatches every step from the host, so it
records each snapshot in the step loop, into a device buffer that moves
to the host once per segment.

Parallel tempering (``ntemps`` > 1, ``sampler/tempering.py``; JAX
``optimizer.py:102-139``): ``nchains`` stays the number of posterior
chains, and each gets ``ntemps - 1`` heated replicas on the chain axis,
rung fastest, so the device runs ``nchains * ntemps`` chains.  A sweep
runs after every ``swap_every``-th whole cycle; during burn-in the
ladder adapts toward equal adjacent swap rates (``adapt_ladder``) and
it is frozen for the main phase.  The ``.npy`` files hold the beta = 1
rows only, and the checkpoint carries the ladder, so that a tempered
resume is bit for bit too.  Sweeps run only on the cycle schedule: with
``thin`` below a cycle's length or ``fused_cycles`` off, none runs (as
in the JAX package), and the optimizer warns.

The optimizer runs on a CUDA device unless the caller passes another
``device`` (the CPU runs the kernels' plain twins).  ``devices`` (a
list, one spawned worker process per entry, ``parallel/mesh.py``)
splits the chains over several devices, as the JAX package's
``devices`` shards them; by default (neither given) every visible CUDA
device takes a part, and one GPU runs in this process as before.  Each
worker holds a contiguous block of whole temperature groups
(``mesh.chain_sharding``) and runs the steps of its rows; this process
runs the phase loop (segments, snapshots, the ladder adaptation,
checkpoints, the progress line, the ``.npy`` files) over the blocks
(``_blocks``).  A worker draws as the one-device run does, so with
``resort_chains`` off the files, the final states and a checkpoint are
those of the one-device run bit for bit (for the built-in SWD and RF
targets: a custom target's forward is held to it only if its rounding
of a chain does not depend on the batch's shape); with it on, each
block is sorted within itself, a relabelling that gives another sample
path of the same transition kernel.  The checkpoint has one format: a
split run resumes on one device and a one-device run resumes split.
"""

import dataclasses
import logging
import os
import os.path as op
import time

import numpy as np
import torch

from bayhunter_tpu_torch import config as cfgio
from bayhunter_tpu_torch import convert, ops
from bayhunter_tpu_torch.parallel import mesh
from bayhunter_tpu_torch.sampler import tempering
from bayhunter_tpu_torch.sampler.chain import (SNAP_NAMES, Sampler, Sweep,
                                               cycle_moves, make_config,
                                               remainder_moves,
                                               resort_states)
from bayhunter_tpu_torch.sampler.evaluator import build_evaluator

logger = logging.getLogger(__name__)


class MCMC_Optimizer(object):
    """Joint McMC inversion over many parallel chains."""

    def __init__(self, targets, initparams=dict(), priors=dict(),
                 random_seed=None, dtype=torch.float32, device=None,
                 devices=None):
        self._setup(targets, initparams, priors, random_seed, dtype, device,
                    devices)
        self.savepath = op.join(self.initparams['savepath'], 'data')
        os.makedirs(self.savepath, exist_ok=True)
        # config pickle for offline plotting (src/mcmcOptimizer.py:52-55)
        outfile = op.join(self.savepath, '%s_config.pkl' % self.station)
        cfgio.save_config(targets, outfile, priors=self.priors,
                          initparams=self.initparams)

    @classmethod
    def without_files(cls, targets, initparams=dict(), priors=dict(),
                      random_seed=None, dtype=torch.float32, device=None,
                      devices=None):
        """The sampler, its chains and the phase loop without the
        savepath and the config pickle: the single-chain front end
        (``sampler.chain.SingleChain``) runs its ``_init_states`` and
        ``_run_phase``, and its ``mp_inversion`` keeps each phase's
        snapshots in ``snapshots[tag]`` (the layout of the ``.npy``
        files) instead of writing them, with no checkpoint."""
        self = cls.__new__(cls)
        self._setup(targets, initparams, priors, random_seed, dtype, device,
                    devices)
        self.savepath = None
        return self

    def _setup(self, targets, initparams, priors, random_seed, dtype,
               device, devices=None):
        # devices: the split's devices, None for a run in this process
        # (self.device; a split keeps its gathered states on the CPU)
        self.device, self.devices = mesh.resolve_devices(
            device, devices, self.__class__.__name__)
        # float32 runs take the batch path, float64 runs the per-chain
        # ring path (bayhunter_tpu/optimizer.py:76-79 on a TPU)
        self.dtype = dtype
        self.sock_addr = 'tcp://*:5556'
        self.rstate = np.random.RandomState(random_seed)
        self.seed = random_seed if random_seed is not None \
            else int(self.rstate.randint(2 ** 31))

        defaults = cfgio.get_path('defaults.ini')
        self.priors, self.initparams = cfgio.load_params(defaults)
        self.priors.update(priors)
        self.initparams.update(initparams)
        self.station = self.initparams.get('station')

        self.targets = targets
        self.nchains = int(self.initparams.get('nchains'))
        self.ntargets = len(targets.targets)

        self.iter_phase1 = int(self.initparams['iter_burnin'])
        self.iter_phase2 = int(self.initparams['iter_main'])
        self.iterations = self.iter_phase1 + self.iter_phase2
        self.maxlayers = int(self.priors['layers'][1]) + 1

        noiserefs = [t.noiseref for t in targets.targets]
        self.cfg = make_config(self.priors, self.initparams, noiserefs,
                               nl=self.maxlayers, dtype=dtype)
        # a split run's workers evaluate; this process keeps the sampler
        # for the move schedule alone
        self.eval_fn = None if self.devices else build_evaluator(
            targets, self.priors, self.initparams, self.maxlayers,
            self.device, dtype, use_batch_swd=dtype == torch.float32)
        self.sampler = Sampler(self.eval_fn, self.cfg, self.device)

        # parallel tempering: nchains posterior chains, each with
        # ntemps - 1 heated replicas on the chain axis, rung fastest
        self.ntemps = int(self.initparams.get('ntemps', 1))
        self.nchains_total = self.nchains * self.ntemps
        self.tempering_plan = None
        if self.ntemps > 1:
            self.sampler, self.tempering_plan = tempering.attach(
                self.sampler, self.nchains_total, self.ntemps,
                tmax=float(self.initparams.get('tmax', 1000.0)),
                swap_every=int(self.initparams.get('swap_every', 1)))
            # burn-in ladder adaptation toward equal adjacent swap
            # rates, frozen for the main phase
            self._ladder_adapt = bool(self.initparams.get('adapt_ladder',
                                                          True))
            self._ladder_rung_betas = None   # from states.beta at first
            self._ladder_prev = None
            self._ladder_nupd = 0
            logger.info(
                '> Parallel tempering: %d rungs (tmax %.1f), swap sweep '
                'every %d cycles%s.'
                % (self.ntemps, self.tempering_plan.tmax,
                   self.tempering_plan.swap_every,
                   ', burn-in ladder adaptation on'
                   if self._ladder_adapt else ''))

        # chain resort between segments (resort_states): rows sorted by
        # layer count; snapshots and checkpoints undo it through _perm
        self._resort = bool(self.initparams.get('resort_chains', True))
        self._perm = None
        self._gen = None
        self._segment = None     # (size, calibrated) of a resumed phase
        self._rows = None        # a worker's row block (mesh.Workers)
        self._pool = None        # the workers of a split run
        self.blocks = None
        self.worker_reports = self.pool_stats = None
        self._launches_at_init = None
        self.snapshots = {}      # without files: the phases' snapshots
        if self.devices:
            self.blocks = mesh.chain_sharding(
                self.nchains_total, self.devices, self.ntemps)

        logger.info('> %d chain(s) are initiated on %s...'
                    % (self.nchains, self.device if not self.devices
                       else ', '.join(map(str, self.devices))))

    # ------------------------------------------------------------------

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # the chains by row block: in this process, every method
    # ``_block_*(states, ...) -> (states, out)`` runs on the whole batch;
    # in a split run each worker runs it on its own rows (mesh.Workers)
    # and ``states`` here is the pool
    # ------------------------------------------------------------------

    def _blocks(self, states, name, *args, each=None):
        """Run the block operation ``name`` on every row block; returns
        (states, [each block's output on the host])."""
        if isinstance(states, mesh.Workers):
            return states, states.call(name, *args, each=each)
        states, out = getattr(self, name)(states, *args,
                                          *(each[0] if each else ()))
        return states, [mesh.to_host(out)]

    def _fields(self, states, names):
        """The named per-chain fields of every chain, host arrays in row
        order."""
        return mesh.concat(self._blocks(states, '_block_fields', names)[1])

    def _host_state(self, states):
        """(state fields as numpy, the generator's state, the resort map
        or None) of the whole batch; a split run's workers hold one
        generator state, which is checked."""
        outs = self._blocks(states, '_block_state')[1]
        gens = [o[1] for o in outs]
        if any(not np.array_equal(g, gens[0]) for g in gens):
            raise RuntimeError('the workers\' generators drifted apart')
        perms = [o[2] for o in outs]
        perm = None if perms[0] is None else mesh.concat(perms)
        return mesh.concat([o[0] for o in outs]), gens[0], perm

    def _gathered(self, states):
        """The whole batch as one ChainState (a split run's on the
        CPU)."""
        if not isinstance(states, mesh.Workers):
            return states
        return convert.state_from_numpy(self._host_state(states)[0],
                                        self.device, self.dtype)

    def _open_pool(self):
        """Start the workers of a split run, one per entry of
        ``devices`` with its block; the kernels are built here first, so
        that every worker loads that library."""
        self._close_pool(terminate=True)
        if any(d.type == 'cuda' for d in self.devices):
            from bayhunter_tpu_torch.ops import _ext
            _ext.load()
        self._pool = mesh.Workers(
            self.devices, self.blocks, _worker_optimizer,
            (self.targets, self.initparams, self.priors, self.seed,
             self.dtype))
        return self._pool

    def _close_pool(self, terminate=False):
        """Close (or end) a split run's workers; their reports go to
        ``worker_reports``, each with its launch counts at the end of
        the cold init or load (``launches_at_init``), the pool's times
        to ``pool_stats`` (``mesh.Workers.stats``)."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        if terminate:
            pool.terminate()
            return
        at_init = self._launches_at_init
        self.worker_reports = pool.close()
        self.pool_stats = pool.stats()
        for i, rep in enumerate(self.worker_reports):
            rep['launches_at_init'] = at_init[i] if at_init else None

    def _block_init(self, states):
        betas = None if self.tempering_plan is None \
            else self.tempering_plan.betas
        states, self._gen = self.sampler.init_states_host(
            self.seed, self.nchains_total, betas=betas)
        return states, None

    def _block_fields(self, states, names):
        return states, {k: getattr(states, k) for k in names}

    def _block_record(self, states):
        return states, self._record(states)

    def _block_state(self, states):
        return states, (convert.state_to_numpy(states),
                        self._gen.get_state().numpy(),
                        None if self._perm is None
                        else self._perm.cpu().numpy())

    def _block_load(self, states, fields, gen_state, perm):
        states = convert.state_from_numpy(fields, self.device, self.dtype)
        self._gen = torch.Generator(device=self.device)
        self._gen.set_state(torch.from_numpy(gen_state))
        if perm is not None:
            self._perm = torch.tensor(perm, device=self.device)
        return states, None

    def _block_set_beta(self, states, betas):
        if self._rows is not None:
            betas = betas[self._rows.start:self._rows.stop]
        return dataclasses.replace(states, beta=torch.tensor(
            betas, dtype=states.beta.dtype, device=states.beta.device)), None

    def _block_resort(self, states):
        """Sort the block's rows by layer count (whole temperature
        groups under tempering); the map holds global row indices."""
        if self._perm is None:
            a, b = (0, self.nchains_total) if self._rows is None \
                else (self._rows.start, self._rows.stop)
            self._perm = torch.arange(a, b, device=self.device)
        states, self._perm = resort_states(states, self._perm, self.ntemps)
        return states, None if self._rows is None else self._perm

    def _block_segment(self, states, it_global, step, offsets, use_cycles):
        """Advance the block ``step`` iterations from global iteration
        ``it_global`` and record its snapshot after each iteration of
        ``offsets``; returns the (len(offsets), rows, W) snapshot rows."""
        sampler, gen = self.sampler, self._gen
        width = 2 * self.maxlayers + self.ntargets + 3 + states.noise.shape[1]
        buf = torch.empty((len(offsets), states.n.shape[0], width),
                          dtype=states.logL.dtype, device=self.device)
        moves = (cycle_moves if use_cycles else remainder_moves)(
            sampler, it_global, step, gen)
        i = j = 0
        for move in moves:
            states = sampler.advance(states, move, gen)
            # a sweep takes no iteration: the offsets count moves
            if isinstance(move, Sweep):
                continue
            i += 1
            if j < len(offsets) and i == offsets[j]:
                self._record(states, out=buf[j])
                j += 1
        self._sync()
        return states, buf.cpu().numpy()

    # ------------------------------------------------------------------

    def _init_states(self):
        if not self.devices:
            return self._block_init(None)[0]
        pool = self._open_pool()
        pool.call('_block_init')
        self._launches_at_init = pool.each(ops.launch_counts)
        return pool

    def _phase_plan(self, niter):
        """(thin, n_snap, remainder) so that n_snap <= maxmodels and
        n_snap*thin + remainder == niter."""
        maxmodels = int(self.initparams['maxmodels'])
        if niter <= 0:
            return 1, 0, 0
        thin = int(np.ceil(niter / maxmodels))
        n_snap = niter // thin
        rem = niter - n_snap * thin
        return thin, n_snap, rem

    def _record(self, states, out=None):
        """The snapshot of ``states`` as one (C, W) row block on the
        device: ``[model | logL | misfits | noise | vpvs]``, written
        into ``out`` when given."""
        s = self.sampler.snapshot_fn(states)
        cols = [s['model'], s['logL'][:, None], s['misfits'], s['noise'],
                s['vpvs'][:, None]]
        if out is None:
            return torch.cat(cols, dim=1)
        return torch.cat(cols, dim=1, out=out)

    def _unpack(self, rows):
        """(S, C, W) numpy snapshot rows -> S dicts in the reference's
        save layout, rows restored to the original chain order, the
        beta = 1 rows alone under tempering."""
        if self._perm is not None:
            inv = np.argsort(self._perm.cpu().numpy())
            rows = rows[:, inv]
        if self.tempering_plan is not None:
            rows = rows[:, self.tempering_plan.cold_indices(
                self.nchains_total)]
        nl2 = 2 * self.maxlayers
        nm = self.ntargets + 1
        nn = rows.shape[2] - nl2 - nm - 2
        cuts = np.cumsum([nl2, 1, nm, nn])
        out = []
        for r in rows:
            model, logL, misfits, noise, vpvs = np.split(r, cuts, axis=1)
            out.append(dict(model=model, logL=logL[:, 0], misfits=misfits,
                            noise=noise, vpvs=vpvs[:, 0]))
        return out

    def _snapshot_host(self, states):
        """Record the current per-chain state in the reference's save
        layout (src/SingleChain.py:665-690), in the original chain
        order."""
        rows = mesh.concat(self._blocks(states, '_block_record')[1])
        return self._unpack(rows[None])[0]

    def _run_phase(self, states, niter, label, baywatch_pub=None,
                   dtsend=0.5, t0=None, phase_id=1, start_it=0,
                   parts=None):
        """Run one phase in segments from the host with a snapshot after
        every ``thin``-th iteration; returns (states, snapshots dict of
        stacked (chains, n_snap, ...) arrays).

        The segment is 50 iterations (``segment_iters`` pins it), then
        calibrated once to about ``segment_seconds`` of work.  Between
        segments the snapshots move to the host, the chains are
        resorted, progress is logged and, every
        ``checkpoint_seconds`` (0 disables), a checkpoint is written.
        Whole cycles run when ``thin`` is at least a cycle long and
        ``fused_cycles`` is on, each segment from its first iteration
        (a remainder shorter than a cycle on the random-scan schedule),
        so two runs take the same moves only with equal segments;
        otherwise every iteration's move is drawn on the random-scan
        schedule.  A split run decides the segments here and sends the
        same ones to every worker."""
        thin, n_snap, rem = self._phase_plan(niter)
        if n_snap == 0:
            return states, None
        total = n_snap * thin + rem

        target_s = float(self.initparams.get('segment_seconds', 5.0))
        ckpt_s = float(self.initparams.get('checkpoint_seconds', 600.0))
        if self.savepath is None:
            ckpt_s = 0.0
        seg_pin = int(self.initparams.get('segment_iters', 0))
        seg = seg_pin if seg_pin > 0 else int(min(50, total))
        calibrated = False
        if self._segment is not None:
            seg, calibrated = self._segment
            self._segment = None
        parts = list(parts) if parts else []
        it_done = start_it
        next_log = 0
        last_send = 0.0
        last_ckpt = time.time()
        sampler = self.sampler
        use_cycles = (thin >= len(sampler.late_order)
                      and bool(self.initparams.get('fused_cycles', True)))
        if self.tempering_plan is not None and not use_cycles:
            logger.warning(
                '> %s: thin %d is below the cycle length %d or '
                'fused_cycles is off, so the steps run on the random-scan '
                'schedule and no replica-exchange sweep runs in this phase '
                '(as in the JAX package); lower maxmodels until thin is a '
                'cycle long, or turn fused_cycles on.'
                % (label.strip(), thin, len(sampler.late_order)))
        it_global = int(self._fields(states, ('iiter',))['iiter'][0])
        while it_done < total:
            step = min(seg, total - it_done)
            # the snapshots that fall in this segment, by their offset
            first = thin * (len(parts) + 1) - it_done
            offsets = list(range(first, step + 1, thin))[
                :n_snap - len(parts)]
            t_seg = time.time()
            states, rows = self._blocks(states, '_block_segment', it_global,
                                        step, offsets, use_cycles)
            dt_seg = time.time() - t_seg
            it_done += step
            it_global += step
            parts += self._unpack(np.concatenate(rows, axis=1)
                                  if len(rows) > 1 else rows[0])

            if phase_id == 1 and self.tempering_plan is not None \
                    and self._ladder_adapt:
                states = self._maybe_adapt_ladder(states)

            if self._resort:
                # whole temperature groups move together under tempering
                states, perms = self._blocks(states, '_block_resort')
                if isinstance(states, mesh.Workers):
                    self._perm = torch.from_numpy(mesh.concat(perms))

            if not calibrated and step == seg and seg_pin <= 0:
                calibrated = True
                seg_new = int(np.clip(seg * target_s / max(dt_seg, 1e-3),
                                      1, 2000))
                if seg_new > 2 * seg or seg_new < seg // 2:
                    seg = seg_new

            if it_done >= next_log or it_done >= total:
                next_log += max(thin * 10, 5000)
                self._log_progress(label, states, parts, it_done, total,
                                   t0, self.nchains * step
                                   / max(dt_seg, 1e-9))
            if baywatch_pub is not None \
                    and time.time() - last_send > dtsend:
                self._publish(baywatch_pub,
                              parts[-1] if parts
                              else self._snapshot_host(states))
                last_send = time.time()

            if ckpt_s > 0 and time.time() - last_ckpt > ckpt_s \
                    and it_done < total:
                self.save_checkpoint(states, phase_id, it_done, parts,
                                     (seg, calibrated))
                last_ckpt = time.time()
                logger.info('> checkpoint written (%s, %d/%d it)'
                            % (label.strip(), it_done, total))

        snapshots = {k: np.stack([p[k] for p in parts], axis=1)
                     for k in SNAP_NAMES}
        return states, snapshots

    def _log_progress(self, label, states, parts, it_done, total, t0,
                      rate):
        """The reference's per-segment progress line: layers, logL,
        misfit, acceptance, forward rejects (and their dimension share)
        and proposals/s (src/SingleChain.py:570-582)."""
        snap = parts[-1] if parts else self._snapshot_host(states)
        logL = snap['logL']
        misf = snap['misfits'][:, -1]
        nlay = np.isfinite(snap['model'][:, :self.maxlayers]).sum(axis=1)
        counters = ('accepted', 'proposed', 'fwdfail')
        if self.tempering_plan is not None:
            counters += ('swap_accepted', 'swap_proposed')
        f = self._fields(states, counters)
        acc, prop, ff = f['accepted'], f['proposed'], f['fwdfail']
        swap_info = ''
        if self.tempering_plan is not None:
            # the posterior's rates: the cold rows (a resort moves whole
            # temperature groups, so the rung of a row never changes)
            cold = self.tempering_plan.cold_indices(self.nchains_total)
            acc, prop, ff = acc[cold], prop[cold], ff[cold]
            sacc, sprop = f['swap_accepted'], f['swap_proposed']
            swap_info = ' | %4.1f%% swap' % (100.0 * sacc.sum()
                                             / max(sprop.sum(), 1))
        acc_rate = 100.0 * acc.sum() / max(prop.sum(), 1)
        # forward-solve rejects: slot 2 is the dimension (birth/death)
        # slot, where root shifts (and so warm-cap rejects) concentrate
        ffail_rate = 100.0 * ff.sum() / max(prop.sum(), 1)
        ffail_dim = 100.0 * ff[:, 2].sum() / max(prop[:, 2].sum(), 1)
        runtime = time.time() - (t0 or time.time())
        logger.info(
            '%s %7d/%d it | %4.1f lay | logL med %9.1f | '
            'joint misfit med %8.3f | %4.1f%% acc | '
            '%4.2f%% fwd-rej (dim %4.2f%%)%s | %6.1f s | %6.0f prop/s'
            % (label, it_done, total, float(np.median(nlay)),
               float(np.median(logL)), float(np.median(misf)), acc_rate,
               ffail_rate, ffail_dim, swap_info, runtime, rate))
        if ffail_dim > 20.0:
            logger.warning('> %4.1f%% of dimension proposals rejected by '
                           'forward-solve failure (warm-cap sentinel) — '
                           'check propdist.' % ffail_dim)

    def _maybe_adapt_ladder(self, states):
        """One burn-in ladder adaptation (JAX ``optimizer.py:380-413``):
        once every gap holds 64 proposals since the last update, nudge
        the temperature gaps toward equal adjacent swap rates
        (``tempering.adapt_ladder``) over all chains.  Returns the
        states with the new betas."""
        plan = self.tempering_plan
        f = self._fields(states, ('swap_accepted', 'swap_proposed'))
        acc, prop = f['swap_accepted'], f['swap_proposed']
        rates, nprop = tempering.rung_swap_rates(acc, prop, plan.ntemps,
                                                 prev=self._ladder_prev)
        if nprop.min() < 64:
            return states
        if self._ladder_rung_betas is None:
            self._ladder_rung_betas = self._fields(states, ('beta',))[
                'beta'][:plan.ntemps].astype(float)
        self._ladder_prev = (acc, prop)
        self._ladder_nupd += 1
        step = 0.6 / (1.0 + self._ladder_nupd / 10.0)
        self._ladder_rung_betas = tempering.adapt_ladder(
            self._ladder_rung_betas, rates, step)
        betas = np.tile(self._ladder_rung_betas,
                        self.nchains_total // plan.ntemps)
        self.tempering_plan = plan._replace(betas=betas)
        logger.debug('> ladder adapted (update %d): swap rates %s, betas %s'
                     % (self._ladder_nupd, np.round(rates, 2).tolist(),
                        np.round(self._ladder_rung_betas, 4).tolist()))
        return self._blocks(states, '_block_set_beta', betas)[0]

    def _publish(self, socket, snaps):
        """Latest-state telemetry in the reference BayWatch wire layout
        (reference: src/mcmcOptimizer.py:140-200): three arrays —
        [vpvs | model], likes, noise."""
        C = self.nchains
        models = np.asarray(snaps['model'])[:C, :].astype(np.float32)
        vpvs = np.asarray(snaps['vpvs'])[:C, None].astype(np.float32)
        likes = np.asarray(snaps['logL'])[:C, None].astype(np.float32)
        noise = np.asarray(snaps['noise'])[:C, :].astype(np.float32)
        socket.send_array(np.concatenate((vpvs, models), axis=1))
        socket.send_array(likes)
        socket.send_array(noise)

    # ------------------------------------------------------------------
    # checkpoint / resume: the chain state, the resort map, the
    # generator's state and the phase bookkeeping in one npz, so that a
    # resumed run continues on the same random stream
    # ------------------------------------------------------------------

    @property
    def ckptfile(self):
        return op.join(self.savepath, 'checkpoint.npz')

    def save_checkpoint(self, states, phase, it_done, parts, segment):
        payload = {}
        fields, gen_state, perm = self._host_state(states)
        for key in convert.FLOAT_FIELDS + convert.INT_FIELDS:
            payload['state_' + key] = fields[key]
        for t, entry in enumerate(fields['cache']):
            for k, a in enumerate(entry):
                payload['cache_%d_%d' % (t, k)] = a
        payload['generator'] = gen_state
        payload['phase'] = np.asarray(phase)
        payload['it_done'] = np.asarray(it_done)
        payload['segment'] = np.asarray(segment, np.int64)
        if perm is not None:
            payload['perm'] = perm
        if self.tempering_plan is not None:
            payload['ladder_betas'] = self.tempering_plan.betas
            payload['ladder_nupd'] = np.asarray(self._ladder_nupd)
            if self._ladder_rung_betas is not None:
                payload['ladder_rung_betas'] = self._ladder_rung_betas
            if self._ladder_prev is not None:
                payload['ladder_prev'] = np.stack(self._ladder_prev)
        for key in SNAP_NAMES:
            payload['parts_' + key] = np.asarray(
                [p[key] for p in parts], np.float32)
        tmpfile = self.ckptfile + '.tmp.npz'
        np.savez(tmpfile, **payload)
        os.replace(tmpfile, self.ckptfile)

    def load_checkpoint(self):
        """Returns (states, phase, it_done, parts) or None; a split run
        sends each worker the rows of its block."""
        if not op.exists(self.ckptfile):
            return None
        data = np.load(self.ckptfile, allow_pickle=False)
        fields = {key: data['state_' + key]
                  for key in convert.FLOAT_FIELDS + convert.INT_FIELDS}
        fields['cache'] = tuple(
            tuple(data['cache_%d_%d' % (t, k)] for k in range(3))
            for t in range(self.ntargets))
        # the resort map of the saved rows, kept even if resort_chains
        # is now off
        perm = data['perm'] if 'perm' in data else None
        if not self.devices:
            states = self._block_load(None, fields, data['generator'],
                                      perm)[0]
        else:
            states = self._open_pool()
            states.call('_block_load', each=[
                (part, data['generator'],
                 None if perm is None else perm[r.start:r.stop])
                for part, r in zip(mesh.shard_states(fields, self.blocks),
                                   self.blocks)])
            self._launches_at_init = states.each(ops.launch_counts)
            if perm is not None:
                self._perm = torch.from_numpy(perm)
        if self.tempering_plan is not None:
            self.tempering_plan = self.tempering_plan._replace(
                betas=data['ladder_betas'])
            self._ladder_nupd = int(data['ladder_nupd'])
            self._ladder_rung_betas = data['ladder_rung_betas'] \
                if 'ladder_rung_betas' in data else None
            self._ladder_prev = tuple(data['ladder_prev']) \
                if 'ladder_prev' in data else None
        seg, calibrated = (int(v) for v in data['segment'])
        self._segment = (seg, bool(calibrated))
        stacked = {key: data['parts_' + key] for key in SNAP_NAMES}
        parts = [{key: stacked[key][i] for key in SNAP_NAMES}
                 for i in range(len(stacked['logL']))]
        return states, int(data['phase']), int(data['it_done']), parts

    # ------------------------------------------------------------------

    def mp_inversion(self, nthreads=0, baywatch=False, dtsend=0.5,
                     resume=False):
        """Run the full inversion.  ``nthreads`` is accepted for
        reference API compatibility and ignored (chains run as one
        batch, or one batch per worker of a split run, whose workers are
        closed before this returns).  With ``resume=True`` an existing
        ``checkpoint.npz`` in the savepath continues a previous run."""
        t0 = time.time()

        socket = None
        if baywatch:
            try:
                import zmq
                from bayhunter_tpu_torch.utils import SerializingContext
                context = SerializingContext()
                socket = context.socket(zmq.PUB)
                socket.bind(self.sock_addr)
                logger.info('Starting BayWatch publisher on %s...'
                            % self.sock_addr)
            except Exception as exc:
                logger.warning('BayWatch publisher unavailable: %s' % exc)

        try:
            p2 = self._phases(t0, socket, dtsend, resume)
        except BaseException:
            self._close_pool(terminate=True)
            raise
        self._close_pool()

        # convergence evidence over the main-phase traces: split-R-hat
        # and ESS of the pooled likelihood trace (diagnostics.py)
        if p2 is not None and p2['logL'].shape[1] >= 4:
            from bayhunter_tpu_torch import diagnostics
            rep = diagnostics.convergence_report(
                {'logL': p2['logL']})['logL']
            logger.info(
                '> convergence: logL split-R-hat %.4f, ESS %.0f '
                '(%.1f/chain)%s'
                % (rep['rhat'], rep['ess'], rep['ess_per_chain'],
                   '' if rep['converged']
                   else ' — R-hat > 1.01: chains disagree, consider '
                        'longer burn-in'))

        runtime = time.time() - t0
        total_props = self.iterations * self.nchains
        logger.info('> All chains terminated after: %.5f s' % runtime)
        logger.info('### time for inversion: %.2f s (%.0f proposals/s '
                    'aggregate)' % (runtime, total_props / runtime))
        if socket is not None:
            time.sleep(2 * dtsend)
            socket.close()
        return runtime

    def _phases(self, t0, socket, dtsend, resume):
        """Both phases from the chains' start or the checkpoint, their
        snapshots written (or kept), ``final_states`` gathered; returns
        the main phase's snapshots."""
        ckpt = self.load_checkpoint() if resume and self.savepath else None
        if ckpt is not None:
            states, phase0, it0, parts0 = ckpt
            logger.info('> Resuming from checkpoint: phase %d, '
                        '%d iterations done.' % (phase0, it0))
        else:
            states = self._init_states()
            phase0, it0, parts0 = 1, 0, []

        if phase0 <= 1:
            states, p1 = self._run_phase(
                states, self.iter_phase1, 'burn-in', baywatch_pub=socket,
                dtsend=dtsend, t0=t0, phase_id=1, start_it=it0,
                parts=parts0)
            self._save_phase(p1, 'p1')
            it0, parts0 = 0, []
        states, p2 = self._run_phase(
            states, self.iter_phase2, 'main   ', baywatch_pub=socket,
            dtsend=dtsend, t0=t0, phase_id=2, start_it=it0,
            parts=parts0)
        self._save_phase(p2, 'p2')
        if self.savepath is not None and op.exists(self.ckptfile):
            os.remove(self.ckptfile)
        self.final_states = self._gathered(states)
        return p2

    def _save_phase(self, snaps, tag):
        """Write the reference's per-chain .npy contract
        (reference: src/SingleChain.py:665-690); without files the
        snapshots stay in ``snapshots[tag]``.  This process writes the
        files of a split run too: it holds every snapshot already, and
        two workers writing a share each won 6 of 10 paired rounds on
        one card (``tools/split_files.py``), no gain."""
        if snaps is None:
            return
        if self.savepath is None:
            self.snapshots[tag] = snaps
            return
        write_chains(self.savepath, snaps, tag)
        nmodels = snaps['logL'].shape[1]
        logger.info('> Saving %d models (%s phase) for %d chains.'
                    % (nmodels, tag, self.nchains))


def write_chains(path, snaps, tag, first=0):
    """The ``.npy`` files of the chains ``first, first + 1, ...`` of
    ``snaps`` (each key (chains, n_snap, ...)) under their global
    index: ``c%03d_<tag><name>.npy``, float32."""
    for i in range(len(snaps['logL'])):
        for key, name in SNAP_NAMES.items():
            arr = np.asarray(snaps[key][i], np.float32)
            np.save(op.join(path, 'c%.3d_%s%s' % (first + i, tag, name)),
                    arr)


def _worker_optimizer(device, rows, targets, initparams, priors, seed,
                      dtype=torch.float32):
    """One worker of a split run: an optimizer without files on
    ``device`` at the parent's ``dtype`` whose sampler runs ``rows`` of
    the batch (``mesh.Workers``)."""
    opt = MCMC_Optimizer.without_files(targets, initparams, priors, seed,
                                       dtype=dtype, device=device)
    opt.sampler.rows = opt._rows = rows
    return opt
