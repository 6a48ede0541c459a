"""The reference tutorial's inversion through the JAX package on the CPU,
from several seeds: the JAX side of the posterior spread that
``tools/tutorial_recovery.py`` measures for the port on the card.

    JAX_PLATFORMS=cpu python3 tools/jax_tutorial_runs.py --time \
        [--schedule 4096 2048]
    JAX_PLATFORMS=cpu python3 tools/jax_tutorial_runs.py --seeds 1 2 3 \
        [--jobs 3] [--schedule 4096 2048] \
        [--out results/jax_tutorial_runs.json]

Each seed runs the JAX package's ``MCMC_Optimizer.mp_inversion`` on the
tutorial's configuration (``tutorial/config.ini`` with
``tutorial/tutorialhunt.py``'s updates, ``bench_config.tutorial_params``:
21 chains, 32,768 + 16,384 iterations unless ``--schedule BURNIN MAIN``
says otherwise, ``gauss_dof_correction``) on the data of
``bench_config.tutorial_targets`` (the fixtures plus the
``RandomState(333)`` noise, the same arrays the port inverts), and
prints one JSON line: wall seconds, the posterior summary of its main
phase by ``chip_smoke.recovery_summary``, the function that summarises
the port's runs (layer-count histogram and mode, P(5) + P(6), the
medians of sigma_RF, sigma_SWD and vp/vs), under ``per_chain`` the
per-chain statistics of ``tools/posterior_compare.chain_stats``, which
``tools/posterior_compare.py`` holds against the port's, and under
``moves`` the final states' per-move acceptance, forward rejects and
proposal widths (``posterior_compare.move_stats``).  ``--jobs N``
runs N seeds at once, each in a process of its own with one XLA CPU
thread.

The segment is pinned at one iteration (``segment_iters`` 1): the JAX
optimizer takes its snapshots at segment ends and, with a longer
segment, repeats a segment's last state in place of the iterations
inside it; with segments of one iteration and thin 1 each iteration's
state is recorded once, as the port records it.  The move schedule is a
function of the global iteration, so the pin changes no move.

``--time`` runs one seed until 1,024 iterations past its first 64 (by
then every move's step is compiled) and prints the seconds per
iteration and the projected seconds of a whole run.

This tool imports both packages; it runs the JAX package on the CPU
only (it refuses another JAX platform).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

from posterior_compare import chain_stats, move_stats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

WARMUP = 64          # iterations that compile every move's step
TIMED = 1024         # iterations timed after them


class _Timed(Exception):
    """Ends a ``--time`` run once its iterations are timed."""


def jax_targets():
    """The JAX package's joint target on the arrays of
    ``bench_config.tutorial_targets``."""
    from bayhunter_tpu import Targets
    from bayhunter_tpu_torch import bench_config
    port, _ = bench_config.tutorial_targets()
    sw, prf = port.targets
    jsw = Targets.RayleighDispersionPhase(sw.obsdata.x, sw.obsdata.y,
                                          yerr=sw.obsdata.yerr)
    jprf = Targets.PReceiverFunction(prf.obsdata.x, prf.obsdata.y)
    jprf.moddata.plugin.set_modelparams(gauss=1., water=0.01, p=6.4)
    return Targets.JointTarget(targets=[jsw, jprf])


def optimizer(seed, savepath, schedule=None):
    """The JAX package's ``MCMC_Optimizer`` of the tutorial from
    ``seed`` at ``schedule`` (burn-in, main iterations; None: the
    tutorial's), its segment pinned at one iteration, writing under
    ``savepath``."""
    from bayhunter_tpu import MCMC_Optimizer
    from bayhunter_tpu_torch import bench_config
    priors, ip = bench_config.tutorial_params()
    ip.update(savepath=savepath, segment_iters=1)
    if schedule is not None:
        ip.update(iter_burnin=schedule[0], iter_main=schedule[1])
    return MCMC_Optimizer(jax_targets(), initparams=ip, priors=priors,
                          random_seed=seed)


def run_seed(seed, tmp, schedule=None):
    """One whole run of ``seed``: its wall seconds and summaries."""
    import chip_smoke as cs
    opt = optimizer(seed, os.path.join(tmp, 's%d' % seed), schedule)
    t0 = time.perf_counter()
    opt.mp_inversion()
    wall = time.perf_counter() - t0
    view = types.SimpleNamespace(savepath=opt.savepath,
                                 maxlayers=opt.maxlayers,
                                 nchains=opt.nchains)
    out = dict(seed=seed, package='bayhunter_tpu (JAX, CPU)',
               chains=opt.nchains, iterations=opt.iterations,
               schedule=[opt.iter_phase1, opt.iter_phase2], wall_s=wall)
    out.update(cs.recovery_summary(view))
    out['per_chain'] = chain_stats(opt.savepath, opt.nchains, opt.maxlayers)
    st = opt.final_states
    out['moves'] = move_stats(*(np.asarray(x)[:opt.nchains] for x in (
        st.accepted, st.proposed, st.fwdfail, st.propdist)))
    return out


def time_seed(seed, tmp, schedule=None):
    """Seconds per iteration of ``TIMED`` iterations past the first
    ``WARMUP`` of one seed's burn-in, and the projection of a whole run
    at ``schedule``.  Thin is 1 and the segment one iteration, so a
    snapshot is taken, and the clock read, after every iteration."""
    opt = optimizer(seed, os.path.join(tmp, 't%d' % seed), schedule)
    snap = opt._snapshot_host
    marks = []            # seconds at each snapshot
    t_start = time.perf_counter()

    def timed(states):
        out = snap(states)
        marks.append(time.perf_counter() - t_start)
        if len(marks) == WARMUP + TIMED:
            raise _Timed
        return out

    opt._snapshot_host = timed
    try:
        opt.mp_inversion()
        raise SystemExit('the timed run ended before %d iterations'
                         % (WARMUP + TIMED))
    except _Timed:
        pass
    t_a, t_b = marks[WARMUP - 1], marks[-1]
    per_iter = (t_b - t_a) / TIMED
    return dict(seed=seed, warmup_iterations=WARMUP, warmup_s=t_a,
                timed_iterations=TIMED, s_per_iteration=per_iter,
                projected_run_s=t_a + (opt.iterations - WARMUP) * per_iter)


def run_parallel(seeds, jobs, out, schedule=None):
    """The runs of ``seeds`` in child processes, at most ``jobs`` at
    once; their JSON lines in the order of ``seeds``."""
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_cpu_multi_thread_eigen=false '
               'intra_op_parallelism_threads=1',
               OMP_NUM_THREADS='1')
    pending = list(enumerate(seeds))
    running, runs = [], [None] * len(seeds)
    while pending or running:
        while pending and len(running) < jobs:
            i, seed = pending.pop(0)
            cmd = [sys.executable, os.path.abspath(__file__),
                   '--seeds', str(seed)]
            if schedule is not None:
                cmd += ['--schedule', str(schedule[0]), str(schedule[1])]
            running.append((i, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, text=True, env=env)))
        i, proc = running.pop(0)
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit('seed %d failed (exit %d)'
                             % (seeds[i], proc.returncode))
        runs[i] = json.loads(text.strip().splitlines()[-1])
        runs[i]['jobs'] = jobs
        print(json.dumps(runs[i]), flush=True)
        if out:
            with open(out, 'w') as f:
                json.dump([r for r in runs if r], f, indent=1)
    return runs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, nargs='+', default=[1])
    ap.add_argument('--jobs', type=int, default=1)
    ap.add_argument('--time', action='store_true')
    ap.add_argument('--schedule', type=int, nargs=2, default=None,
                    metavar=('BURNIN', 'MAIN'))
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if os.environ.get('JAX_PLATFORMS') != 'cpu':
        raise SystemExit('run with JAX_PLATFORMS=cpu: this tool runs the '
                         'JAX package on the CPU only')
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
    if args.jobs > 1 and not args.time:
        run_parallel(args.seeds, args.jobs, args.out, args.schedule)
        return
    tmp = tempfile.mkdtemp(prefix='bh_jax_tutorial_')
    try:
        runs = []
        for seed in args.seeds:
            run = time_seed if args.time else run_seed
            r = run(seed, tmp, args.schedule)
            print(json.dumps(r), flush=True)
            runs.append(r)
            shutil.rmtree(os.path.join(tmp, 's%d' % seed),
                          ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(runs, f, indent=1)


if __name__ == '__main__':
    main()
