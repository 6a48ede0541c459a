"""Time who writes a split run's ``.npy`` files on one card: the calling
process alone, or two workers, a share each.

    python3 tools/split_files.py [--rounds 3]

Runs ``chip_smoke.py`` (k-2)'s configuration (the tutorial's targets,
10,240 chains, ``SPLIT_ITERS``, ``SPLIT_MAXMODELS``, resort off) once on
``cuda:0`` without files for its snapshots, then writes the same
snapshots (both phases: 102,400 files) with ``optimizer.write_chains``
into a fresh temporary directory, in turns by the calling process (as
``MCMC_Optimizer._save_phase`` writes them) and by two spawned
``mesh.Workers`` on ``cuda:0`` (each its share of the chains under
their global index, sent over the pipes), in the order parent,
workers, workers, parent, ... (``--rounds`` of each); each round's
directory is removed, untimed, before the next.  Prints the card's name
and power limit and, as its last line, one JSON object: each round's
seconds by writer, the median of each, their ratio, the pairs the
workers won and the files a round wrote.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITERS = ('parent', 'workers')


def order(rounds):
    """The writers' turns: parent, workers, workers, parent, ..."""
    out = []
    while len(out) < 2 * rounds:
        out += [WRITERS[0], WRITERS[1], WRITERS[1], WRITERS[0]]
    return out[:2 * rounds]


class Writer(object):
    """A worker's writer: the files of its share of the chains."""

    def save(self, states, path, tag, first, snaps):
        from bayhunter_tpu_torch.optimizer import write_chains
        write_chains(path, snaps, tag, first)
        return states, None


def writer(device, rows):
    return Writer()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--rounds', type=int, default=3,
                    help='rounds of each writer (default 3)')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('split_files.py needs a CUDA device')
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from bayhunter_tpu_torch import MCMC_Optimizer, bench_config
    from bayhunter_tpu_torch.optimizer import write_chains
    from bayhunter_tpu_torch.parallel import mesh

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    tmp = tempfile.mkdtemp(prefix='bh_split_files_')
    ip.update(nchains=cs.C_MAIN, iter_burnin=cs.SPLIT_ITERS[0],
              iter_main=cs.SPLIT_ITERS[1], maxmodels=cs.SPLIT_MAXMODELS,
              segment_iters=cs.SPLIT_SEGMENT, checkpoint_seconds=0,
              resort_chains=False, savepath=os.path.join(tmp, 'run'))
    try:
        one = MCMC_Optimizer.without_files(targets, ip, priors, cs.OPT_SEED,
                                           device=cs.CARD)
        one.mp_inversion()
        snaps = one.snapshots
        devices = [cs.CARD, cs.CARD]
        shares = mesh.chain_sharding(cs.C_MAIN, devices)
        t = time.perf_counter()
        pool = mesh.Workers(devices, shares, writer)
        start_s = time.perf_counter() - t
        seconds = {w: [] for w in WRITERS}
        files = set()
        with pool:
            for r, who in enumerate(order(args.rounds)):
                path = os.path.join(tmp, 'round%d' % r)
                os.makedirs(path)
                t = time.perf_counter()
                for tag in sorted(snaps):
                    if who == 'parent':
                        write_chains(path, snaps[tag], tag)
                    else:
                        pool.call('save', path, tag, each=[
                            (q.start, {k: v[q.start:q.stop]
                                       for k, v in snaps[tag].items()})
                            for q in shares])
                seconds[who].append(time.perf_counter() - t)
                files.add(len(os.listdir(path)))
                shutil.rmtree(path)
                print('round %d, %s: %.3f s' % (r, who, seconds[who][-1]),
                      flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    med = {w: float(np.median(seconds[w])) for w in WRITERS}
    print(json.dumps(dict(
        chains=cs.C_MAIN, files_a_round=sorted(files),
        worker_start_s=start_s, seconds=seconds, median_s=med,
        workers_over_parent=med['workers'] / med['parent'],
        pairs_workers_won=sum(w < p for p, w in zip(seconds['parent'],
                                                    seconds['workers'])))))


if __name__ == '__main__':
    main()
