"""One phase of ``chip_smoke.py`` on the card, alone or paired with
another tree's, for what the whole script would take too long to
repeat.

    python3 tools/chip_phase.py --phase l
    python3 tools/chip_phase.py --phase b --pair build/parent [--pairs 1]

``--phase b`` runs (b), ``chip_smoke.optimizer_tutorial`` (the
tutorial configuration through ``MCMC_Optimizer`` with its checks);
``--phase d`` runs (d), ``chip_smoke.optimizer_recovery`` (the tutorial
at 21 chains, schedule S, held to its bands); ``--phase l`` runs (l),
``chip_smoke.gates_and_tutorial`` (the sampler gates and the tutorial
scripts); ``--phase m`` runs (m), ``chip_smoke.ring_path`` (the float64
kernels, the per-chain ring path, a float64 optimizer run) and prints
its kernel records.  Each run prints its wall seconds in a
JSON line after the phase's own log.  With ``--pair DIR`` it runs the
phase in turns in the other tree ``DIR`` (a ``git archive`` of another
commit: its ``chip_smoke.py`` and package) and in this one, other,
this, this, other for each pair, each run in a process of its own from
its tree's root (each builds its tree's kernels first, outside the
timed phase), and prints each run's seconds and the medians.  Needs a
CUDA device.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_here(phase):
    """The phase in this process, from the tree of the working
    directory; its wall seconds."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from bayhunter_tpu_torch.ops import _ext
    if not torch.cuda.is_available():
        raise SystemExit('tools/chip_phase.py needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    _ext.load()
    tmp = tempfile.mkdtemp(prefix='bh_chip_phase_')
    try:
        t = time.perf_counter()
        if phase == 'b':
            cs.optimizer_tutorial(torch, tmp)
        elif phase == 'd':
            cs.optimizer_recovery(torch, tmp)
        elif phase == 'm':
            print(json.dumps({'kernels': cs.ring_path(torch, dev, tmp, {})}),
                  flush=True)
        else:
            cs.gates_and_tutorial(torch, dev, tmp, {})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({'phase': phase, 'tree': os.getcwd(),
                      'seconds': seconds}), flush=True)
    return seconds


def run_pairs(phase, other, pairs):
    """The phase in turns in ``other`` and in this tree; the seconds of
    each run by tree."""
    other = os.path.abspath(other)
    seconds = {other: [], ROOT: []}
    for _ in range(pairs):
        for tree in (other, ROOT, ROOT, other):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--phase',
                 phase], cwd=tree, capture_output=True, text=True)
            sys.stdout.write(proc.stdout[-4000:])
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-8000:])
                raise SystemExit('phase %s in %s failed (exit %d)'
                                 % (phase, tree, proc.returncode))
            seconds[tree].append(json.loads(
                proc.stdout.strip().splitlines()[-1])['seconds'])
    print(json.dumps({'phase': phase, 'other': other, 'this': ROOT,
                      'seconds_other': seconds[other],
                      'seconds_this': seconds[ROOT],
                      'median_other': statistics.median(seconds[other]),
                      'median_this': statistics.median(seconds[ROOT])}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--phase', choices=('b', 'd', 'l', 'm'), required=True)
    ap.add_argument('--pair', default=None)
    ap.add_argument('--pairs', type=int, default=1)
    args = ap.parse_args()
    if args.pair:
        run_pairs(args.phase, args.pair, args.pairs)
    else:
        run_here(args.phase)


if __name__ == '__main__':
    main()
