"""The reference tutorial's inversion on the card from several seeds:
the runs that set ``chip_smoke.py``'s recovery bands (``RECOVERY``).

    python3 tools/tutorial_recovery.py --seeds 1 2 3 [--chains 21]
        [--jobs 1] [--schedule 4096 2048] [--no-dof-correction]
        [--dtype float32|float64] [--ring-path]
        [--out results/tutorial_recovery.json]

Each seed runs as ``chip_smoke.tutorial_run`` does: the tutorial's
configuration and data (``tutorial/config.ini`` with
``tutorial/tutorialhunt.py``'s updates; the fixtures plus the port's
``SynthObs`` noise) through ``MCMC_Optimizer.mp_inversion`` on the
card, 32,768 + 16,384 iterations unless ``--schedule BURNIN MAIN``
says otherwise, ``maxmodels`` 50,000, its segment pinned at
``chip_smoke.TUTORIAL_SEGMENT``, ``gauss_dof_correction`` on unless
``--no-dof-correction``, at ``--dtype`` (float32 by default; a float64
run takes the per-chain ring path, as ``MCMC_Optimizer`` picks it), on
the per-chain ring path at float32 too with ``--ring-path`` (the tool
builds that run's evaluator itself, ``build_evaluator(...,
use_batch_swd=False)``: the path of the JAX package's runs off a TPU),
and prints its rate, acceptance, forward
rejects, the posterior summary of its main phase (layer-count
histogram and mode, P(5) + P(6), the medians of sigma_RF, sigma_SWD and
vp/vs), under ``per_chain`` the per-chain statistics of
``tools/posterior_compare.chain_stats`` and under ``moves`` the final
states' per-move counters and proposal widths, as one JSON line, after
the card's name and power limit; ``tools/posterior_compare.py`` holds
such runs against the JAX package's (``tools/jax_tutorial_runs.py``).
``--jobs N`` runs the seeds in N processes at once on the one card (a
seed gives the same sample path either way; the rates of such runs are
shared ones).  A seed may be given twice.  Needs a CUDA device.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
from posterior_compare import chain_stats, move_stats  # noqa: E402


def ring_path_optimizer():
    """``MCMC_Optimizer`` with its evaluator rebuilt without the batch
    path (``build_evaluator(..., use_batch_swd=False)``) at its dtype:
    the per-chain ring path, at float32 too."""
    from bayhunter_tpu_torch import MCMC_Optimizer
    from bayhunter_tpu_torch.sampler.evaluator import build_evaluator

    class RingPath(MCMC_Optimizer):
        def _setup(self, targets, initparams, priors, random_seed, dtype,
                   device, devices=None):
            super()._setup(targets, initparams, priors, random_seed, dtype,
                           device, devices)
            self.eval_fn = self.sampler.ev = build_evaluator(
                targets, self.priors, self.initparams, self.maxlayers,
                self.device, dtype, use_batch_swd=False)

    return RingPath


def tutorial_seed(torch, tmp, seed, chains, schedule=None, dof=True,
                  dtype='float32', ring=False):
    """``chip_smoke.tutorial_run`` of ``seed``, its burn-in and main
    phase those of ``schedule`` (the tutorial's when None),
    ``gauss_dof_correction`` as ``dof`` says, at ``dtype`` and (``ring``)
    on the per-chain ring path; returns (its stats with the schedule,
    the per-chain statistics of its files and its final states'
    per-move counters and widths, launches)."""
    from bayhunter_tpu_torch import bench_config
    targets, sd = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=chains, segment_iters=cs.TUTORIAL_SEGMENT,
              savepath=os.path.join(tmp, 'd%d' % seed),
              gauss_dof_correction=dof)
    if schedule is not None:
        ip.update(iter_burnin=schedule[0], iter_main=schedule[1])
    opt, wall, _, counts = cs.run_optimizer(
        torch, targets, priors, ip, seed,
        cls=ring_path_optimizer() if ring else None,
        dtype=getattr(torch, dtype))
    stats = cs.optimizer_stats(opt, wall)
    st = opt.final_states
    stats.update(seed=seed, sigma_swd_injected=sd,
                 snapshots=cs.check_contract(opt), **cs.recovery_summary(opt))
    stats.update(schedule=[opt.iter_phase1, opt.iter_phase2], dtype=dtype,
                 ring_path=not opt.eval_fn.batch,
                 per_chain=chain_stats(opt.savepath, opt.nchains,
                                       opt.maxlayers),
                 moves=move_stats(*(x[:opt.nchains].cpu().numpy() for x in (
                     st.accepted, st.proposed, st.fwdfail, st.propdist))))
    return stats, counts


def run_seeds(torch, seeds, chains, smi, schedule=None, dof=True,
              dtype='float32', ring=False):
    """The runs of ``seeds`` in this process, one JSON line each."""
    runs = []
    tmp = tempfile.mkdtemp(prefix='bh_recovery_')
    try:
        for seed in seeds:
            stats, counts = tutorial_seed(torch, tmp, seed, chains,
                                          schedule, dof, dtype, ring)
            stats['gauss_dof_correction'] = dof
            stats['launches'] = counts
            stats['device'] = smi
            stats['jobs'] = 1
            print(json.dumps(stats), flush=True)
            runs.append(stats)
            shutil.rmtree(os.path.join(tmp, 'd%d' % seed), ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def run_parallel(seeds, chains, jobs, schedule=None, dof=True,
                 dtype='float32', ring=False):
    """The runs of ``seeds`` in child processes of this script, at most
    ``jobs`` at once; their JSON lines in the order of ``seeds``."""
    from bayhunter_tpu_torch.ops import _ext
    _ext.load()     # built once here, loaded by every child
    pending = list(enumerate(seeds))
    running, out = [], [None] * len(seeds)
    while pending or running:
        while pending and len(running) < jobs:
            i, seed = pending.pop(0)
            cmd = [sys.executable, os.path.abspath(__file__),
                   '--seeds', str(seed), '--chains', str(chains)]
            if schedule is not None:
                cmd += ['--schedule', str(schedule[0]), str(schedule[1])]
            if not dof:
                cmd.append('--no-dof-correction')
            cmd += ['--dtype', dtype] + (['--ring-path'] if ring else [])
            running.append((i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                text=True)))
        i, proc = running.pop(0)
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit('seed %d failed (exit %d)'
                             % (seeds[i], proc.returncode))
        out[i] = json.loads(text.strip().splitlines()[-1])
        out[i]['jobs'] = jobs
        print(json.dumps(out[i]), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, nargs='+', default=[1, 2])
    ap.add_argument('--chains', type=int, default=21)
    ap.add_argument('--jobs', type=int, default=1)
    ap.add_argument('--schedule', type=int, nargs=2, default=None,
                    metavar=('BURNIN', 'MAIN'))
    ap.add_argument('--no-dof-correction', action='store_true',
                    help='gauss_dof_correction off (a shifted sigma_RF '
                    'posterior: the comparison\'s positive control)')
    ap.add_argument('--dtype', default='float32',
                    choices=('float32', 'float64'))
    ap.add_argument('--ring-path', action='store_true',
                    help='the per-chain ring path at float32 too (float64 '
                    'runs take it always)')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('tools/tutorial_recovery.py needs a CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dof = not args.no_dof_correction
    if args.jobs > 1:
        runs = run_parallel(args.seeds, args.chains, args.jobs,
                            args.schedule, dof, args.dtype, args.ring_path)
    else:
        runs = run_seeds(torch, args.seeds, args.chains, smi, args.schedule,
                         dof, args.dtype, args.ring_path)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(runs, f, indent=1)


if __name__ == '__main__':
    main()
