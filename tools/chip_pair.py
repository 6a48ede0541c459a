"""Run ``chip_smoke.py`` of two trees in turns on one card and compare
them.

    python3 tools/chip_pair.py PARENT_DIR [--pairs 5] [--timeout SECONDS]
                               [--out DIR]

PARENT_DIR holds another tree of the repository (for example the parent
commit, unpacked with ``git archive``); the other tree is this one.
Each run is a whole ``chip_smoke.py`` in its tree's root, then this
tree's ``tools/kernel_variants.py --tree`` on that tree's port (K2 by
wave and move class, K3 and K3r case by case, K1, K6 and, where the
tree's K4/K5 take phase velocities, K4/K5 by events and by the
profiler), in the order parent, change, change, parent, change,
parent, parent, change, ... (``--pairs`` runs of each), its log in
``DIR/pair_N_TREE.log`` (``--out``, default ``results/``).  Prints, and
writes to ``DIR/chip_pair.json``, for each tree: each kernel's and
each case's event time (median, range) beside the kernel's bound, the
profiler device times (K1, K4, K5, K6), the registers ptxas gave each
kernel, each main path's proposals/s, cold-init time and reject
percentages, whether the main paths' accepted and proposed counts agree
between the trees run for run, the profile's kernel device times and
device events per iteration, and each cold init's wall time beside its
K3-K6 device time (trees whose ``chip_smoke.py`` logs it).  Exits
non-zero when a run failed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def order(pairs):
    """parent/change run order: ABBA then BAAB, repeated."""
    out = []
    while len(out) < 2 * pairs:
        out += ['parent', 'change', 'change', 'parent'] if len(out) % 8 == 0 \
            else ['change', 'parent', 'parent', 'change']
    return out[:2 * pairs]


def parse(log):
    """The JSON records of one chip_smoke.py log."""
    run = {'paths': {}, 'regs': {}}
    entry = None
    for line in log.splitlines():
        if line.startswith('{"kernels"'):
            run['kernels'] = {k['name']: k
                              for k in json.loads(line)['kernels']}
        elif line.startswith('main path: '):
            rec = json.loads(line[len('main path: '):])
            run['paths'][rec['config']] = rec
        elif line.startswith('profile: '):
            run['profile'] = json.loads(line[len('profile: '):])
        elif line.startswith('cold init profile: '):
            run['cold_init'] = json.loads(line[len('cold init profile: '):])
        elif line.startswith('path A, '):
            run['path_a'] = json.loads(line.split(': ', 1)[1].rsplit(
                ', launches', 1)[0])
        elif 'Compiling entry' in line:
            entry = line.split("'")[1]
        elif 'registers' in line and entry is not None:
            if any(k in entry for k in ('prep_kernel', 'walk_kernel',
                                        'resp_kernel', 'secular_kernel')):
                run['regs'][entry] = line.split('ptxas:')[-1].strip()
            entry = None
    return run


def spread(xs):
    xs = [x for x in xs if x is not None]
    if not xs:
        return None
    return dict(median=float(np.median(xs)), min=float(min(xs)),
                max=float(max(xs)), n=len(xs))


def summary(runs):
    """Per-tree medians and ranges over its runs."""
    out = {'kernels': {}, 'paths': {}, 'regs': runs[0]['regs']}
    for name, k in runs[0]['kernels'].items():
        recs = [r['kernels'][name] for r in runs]
        out['kernels'][name] = dict(
            ms=spread([rec['ms'] for rec in recs]),
            # CUDA events over back-to-back calls: the records' ms, or
            # where ms is the profiler's (K1, K6, K4/K5 on the cold
            # chunk), their wrapper_ms
            events_ms=spread([rec.get('wrapper_ms', rec['ms'])
                              for rec in recs]),
            # the profiler's device time beside an event-timed kernel
            # (K4/K5 at 10,240 chains)
            device_ms=spread([rec.get('device_ms') for rec in recs]),
            bound_ms=k['bound_ms'], bound_by=k['bound_by'],
            plain_ms=spread([r['kernels'][name]['plain_ms'] for r in runs]),
            launches=k['launches'], max_abs_err=max(
                r['kernels'][name]['max_abs_err'] for r in runs))
    out['cases'] = {name: dict(
        ms=spread([r['cases'][name]['ms_median'] for r in runs]),
        device_ms=spread([r['cases'][name].get('device_ms_median')
                          for r in runs]),
        bitwise=all(r['cases'][name]['bitwise'] for r in runs))
        for name in runs[0]['cases']}
    for cfg in runs[0]['paths']:
        recs = [r['paths'][cfg] for r in runs]
        out['paths'][cfg] = dict(
            proposals_per_s=spread([p['proposals_per_s'] for p in recs]),
            init_s=spread([p['init_s'] for p in recs]),
            fwd_reject_pct=sorted({p['fwd_reject_pct'] for p in recs}),
            fwd_reject_dim_pct=sorted({p['fwd_reject_dim_pct']
                                       for p in recs}),
            accepted=recs[0]['accepted'], proposed=recs[0]['proposed'],
            same_every_run=all(p['accepted'] == recs[0]['accepted']
                               and p['proposed'] == recs[0]['proposed']
                               for p in recs),
            peak_mem_gib=recs[0]['peak_mem_gib'])
    prof = [r['profile'] for r in runs]
    out['profile'] = dict(
        device_idle_pct=spread([p['device_idle_pct'] for p in prof]),
        device_events_per_iter=spread([p['device_events_per_iter']
                                       for p in prof]),
        kernel_device_ms_per_iter={
            k: spread([p['kernel_device_ms'][k] / p['profiled_iters']
                       for p in prof])
            for k in prof[0]['kernel_device_ms']})
    if all('cold_init' in r for r in runs):
        out['cold_init'] = {cfg: dict(
            wall_ms=spread([r['cold_init'][cfg]['wall_ms'] for r in runs]),
            device_busy_ms=spread([r['cold_init'][cfg]['device_busy_ms']
                                   for r in runs]),
            kernel_device_ms={k: spread([
                r['cold_init'][cfg]['kernel_device_ms'][k] for r in runs])
                for k in runs[0]['cold_init'][cfg]['kernel_device_ms']})
            for cfg in runs[0]['cold_init']}
    if all('path_a' in r for r in runs):
        out['path_a_s_per_call'] = {
            w: spread([float(np.median(r['path_a'][w]['seconds_per_call'][1:]))
                       for r in runs]) for w in runs[0]['path_a']}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('parent')
    ap.add_argument('--pairs', type=int, default=5)
    ap.add_argument('--timeout', type=int, default=600)
    ap.add_argument('--out', default='results')
    opts = ap.parse_args()
    trees = {'parent': os.path.abspath(opts.parent), 'change': HERE}
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    out_dir = os.path.abspath(opts.out)
    os.makedirs(out_dir, exist_ok=True)
    runs = {'parent': [], 'change': []}
    failed = []
    cases = [sys.executable, os.path.join(HERE, 'tools', 'kernel_variants.py'),
             '--rounds', '1', '--tree']
    for i, tree in enumerate(order(opts.pairs), 1):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, 'chip_smoke.py'],
                           cwd=trees[tree], capture_output=True, text=True,
                           timeout=opts.timeout)
        rc = r.returncode
        log = r.stdout + r.stderr
        if rc == 0:
            k = subprocess.run(cases + [trees[tree]], capture_output=True,
                               text=True, timeout=opts.timeout)
            rc = k.returncode
            log += k.stdout + k.stderr
        with open(os.path.join(out_dir, 'pair_%d_%s.log' % (i, tree)),
                  'w') as f:
            f.write(log)
        print('run %d (%s): rc %d in %.0f s' % (
            i, tree, rc, time.perf_counter() - t0), flush=True)
        if rc != 0:
            failed.append(i)
            continue
        run = parse(r.stdout)
        run['cases'] = next(json.loads(line)['kernels'] for line in
                            k.stdout.splitlines()
                            if line.startswith('{"build": "shipped"'))
        runs[tree].append(run)
    result = {'card': smi, 'order': order(opts.pairs), 'failed': failed}
    for tree, rs in runs.items():
        if rs:
            result[tree] = summary(rs)
    if runs['parent'] and runs['change']:
        p, c = runs['parent'][0]['paths'], runs['change'][0]['paths']
        result['trajectories_identical'] = {
            cfg: all(p[cfg][k] == c[cfg][k] for k in (
                'accepted', 'proposed', 'fwd_reject_pct',
                'fwd_reject_dim_pct'))
            for cfg in p if cfg in c}
        def ratio(part, key):
            ch, pa = result['change'][part], result['parent'][part]
            return {name: ch[name][key]['median'] / pa[name][key]['median']
                    for name in ch if name in pa and ch[name][key]
                    and pa[name][key]}

        # event times (kernel records, cases) and profiler device times
        # (the K1 and K6 cases), each against the same measure
        result['ms_ratio_change_to_parent'] = dict(
            ratio('kernels', 'events_ms'), **ratio('cases', 'ms'))
        result['device_ms_ratio_change_to_parent'] = ratio('cases',
                                                           'device_ms')
    with open(os.path.join(out_dir, 'chip_pair.json'), 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if failed:
        raise SystemExit('runs %s failed' % failed)


if __name__ == '__main__':
    main()
