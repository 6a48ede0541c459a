"""The tutorial posterior of two sets of runs, compared statistic by
statistic: the JAX package's seeds (``tools/jax_tutorial_runs.py``)
against the port's (``tools/tutorial_recovery.py``), or two sets of
one package's seeds (a null control).

    python3 tools/posterior_compare.py A.json B.json [--labels JAX port]
        [--seeds-a 1 2 ...] [--seeds-b ...]
        [--out results/posterior_compare.json]

``A.json`` and ``B.json`` are the ``--out`` files of the run tools: a
list of one JSON object a seed, each with the per-seed summary of
``chip_smoke.recovery_summary`` and, under ``per_chain``, the per-chain
statistics of ``chain_stats``.  Twelve statistics are compared:

- per seed (one sample a seed): the chains kept by the outlier rule,
  the nuclei mode, P(5) + P(6), and the medians of sigma_RF, sigma_SWD
  and vp/vs of the kept chains' better half;
- per chain (one sample a chain of every seed, no outlier filter): the
  medians of sigma_RF, sigma_SWD, vp/vs and logL, the mean nuclei
  count and the share of iterations whose state differs from the one
  before (with thin 1, the chain's acceptance).

Each gets a two-sided Mann-Whitney U test; a statistic differs when
p < 0.01 / 12 (Bonferroni over the twelve statistics).  Beside it
stands the power of the comparison on these samples: the smallest
shift of side B's values, up and down, as a share of the magnitude of
B's median, that the test would flag.  The per-move counters and
widths of the runs' final states (``moves``, one sample a seed: each
move's acceptance, the dimension move's forward rejects, each adapted
proposal width) follow as diagnostics, tested the same way (without
the detectable shifts) but not counted in the twelve: where a
statistic differs, they are the first place to look.  So does one
more diagnostic with its detectable shift, ``sigma_rf_kept``: the
per-chain sigma_RF medians of only the chains each seed's outlier rule
kept (``kept``), the chains nearest convergence.  The tool prints one
line a statistic and, last, one JSON object with the same rows.
"""

import argparse
import json
import os

import numpy as np

PER_SEED = ('chains_kept', 'nlay_mode', 'p56', 'sigma_rf_median',
            'sigma_swd_median', 'vpvs_median')
PER_CHAIN = ('sigma_rf', 'sigma_swd', 'vpvs', 'logl', 'nuclei_mean',
             'changed_share')
# the five counter and width slots of the final states
# (sampler/chain.PARIDX: birth and death share slot 2)
MOVES = ('vs', 'z', 'dim', 'noise', 'vpvs')
ALPHA = 0.01
M = len(PER_SEED + PER_CHAIN)     # the Bonferroni count


def chain_stats(savepath, nchains, maxlayers):
    """Per-chain statistics of a finished run's main phase, from its
    ``c%03d_p2{models,likes,noise,vpvs}.npy`` files: a dict of lists,
    one value a chain.  The medians of sigma_RF (noise column 3),
    sigma_SWD (column 1), vp/vs and logL; the mean nuclei count (the
    finite velocities of a NaN-padded model, as
    ``chip_smoke.recovery_summary`` counts them); and the share of the
    rows after the first whose state (model, noise, vp/vs) differs from
    the row before it, NaN equal to NaN."""
    out = {k: [] for k in PER_CHAIN}
    for c in range(nchains):
        def load(k):
            return np.load(os.path.join(savepath, 'c%.3d_p2%s.npy' % (c, k)))
        models, likes, noise, vpvs = (load(k) for k in
                                      ('models', 'likes', 'noise', 'vpvs'))
        state = np.concatenate([models, noise, vpvs.reshape(len(vpvs), -1)],
                               axis=1)
        a, b = state[1:], state[:-1]
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        changed = ~same.all(axis=1)
        out['sigma_rf'].append(float(np.median(noise[:, 3])))
        out['sigma_swd'].append(float(np.median(noise[:, 1])))
        out['vpvs'].append(float(np.median(vpvs)))
        out['logl'].append(float(np.median(likes)))
        out['nuclei_mean'].append(
            float(np.isfinite(models[:, :maxlayers]).sum(axis=1).mean()))
        out['changed_share'].append(float(changed.mean()))
    return out


def move_stats(accepted, proposed, fwdfail, propdist):
    """The per-move counters and proposal widths of a run's final
    states ((chains, 5) arrays, both phases counted): each move's
    acceptance and forward-reject percentage over all chains, and the
    median over chains of each adapted proposal width."""
    acc, prop, ff = (np.asarray(x, dtype=np.float64).sum(axis=0)
                     for x in (accepted, proposed, fwdfail))
    prop = np.maximum(prop, 1.0)
    return dict(accept_pct=(100.0 * acc / prop).tolist(),
                fwd_reject_pct=(100.0 * ff / prop).tolist(),
                propdist_median=np.median(np.asarray(propdist, dtype=float),
                                          axis=0).tolist())


def samples(runs):
    """Each statistic's sample over ``runs`` (the run tools' JSON
    objects): the per-seed values in seed order, the per-chain values
    of every seed concatenated."""
    out = {k: np.array([r[k] for r in runs], dtype=float) for k in PER_SEED}
    out.update({k: np.concatenate([np.asarray(r['per_chain'][k], dtype=float)
                                   for r in runs]) for k in PER_CHAIN})
    return out


def kept_samples(runs):
    """The sample of ``sigma_rf_kept``: the per-chain sigma_RF medians
    of the chains each run's outlier rule kept, every run's
    concatenated."""
    return np.array([r['per_chain']['sigma_rf'][c] for r in runs
                     for c in r['kept']], dtype=float)


def compare_samples(x, y, power=True):
    """One statistic's row: each side's n, median and range, the
    two-sided Mann-Whitney U of ``x`` against ``y``, its p, whether
    p < ALPHA / M and (``power``) the shifts of ``y`` the test would
    see, up and down (``detectable_shift``)."""
    from scipy.stats import mannwhitneyu
    x, y = np.asarray(x, dtype=float), np.asarray(y, dtype=float)
    u, p = mannwhitneyu(x, y, alternative='two-sided')
    row = {}
    for side, v in (('a', x), ('b', y)):
        row.update({'n_' + side: int(v.size),
                    'median_' + side: float(np.median(v)),
                    'range_' + side: [float(v.min()), float(v.max())]})
    row.update(U=float(u), p=float(p), differs=bool(p < ALPHA / M))
    if power:
        row['detectable'] = [detectable_shift(x, y, sign)
                             for sign in (1.0, -1.0)]
    return row


def detectable_shift(x, y, sign=1.0, rtol=0.01):
    """The smallest d >= 0 (to ``rtol`` of itself) for which ``x``
    against ``y + sign * d * |median(y)|`` gives p < ALPHA / M: the
    location shift of ``y``, as a share of its median's magnitude, that
    the test would see (U moves monotonically with such a shift).
    ``inf`` if even a shift of 100 medians is not seen (too few
    samples)."""
    from scipy.stats import mannwhitneyu
    x, y = np.asarray(x, dtype=float), np.asarray(y, dtype=float)
    scale = abs(float(np.median(y))) or 1.0

    def seen(d):
        return mannwhitneyu(x, y + sign * d * scale,
                            alternative='two-sided')[1] < ALPHA / M

    if seen(0.0):
        return 0.0
    lo, hi = 0.0, 1e-3
    while not seen(hi):
        if hi > 100.0:
            return float('inf')
        lo, hi = hi, 2.0 * hi
    while hi - lo > rtol * hi:
        mid = 0.5 * (lo + hi)
        lo, hi = (lo, mid) if seen(mid) else (mid, hi)
    return hi


def compare(runs_a, runs_b):
    """The rows of every statistic of ``PER_SEED`` and ``PER_CHAIN``,
    by name."""
    sa, sb = samples(runs_a), samples(runs_b)
    return {k: compare_samples(sa[k], sb[k]) for k in PER_SEED + PER_CHAIN}


def move_samples(runs):
    """The per-seed diagnostics of ``runs``' ``moves``: each move's
    acceptance (``accept_<move>``), the dimension move's forward rejects
    and each proposal width (``width_<move>``)."""
    mv = [r['moves'] for r in runs]
    out = {'accept_' + k: [x['accept_pct'][i] for x in mv]
           for i, k in enumerate(MOVES)}
    out['fwd_reject_dim'] = [x['fwd_reject_pct'][2] for x in mv]
    out.update({'width_' + k: [x['propdist_median'][i] for x in mv]
                for i, k in enumerate(MOVES)})
    return out


def compare_moves(runs_a, runs_b):
    """The diagnostic rows of ``move_samples``, at the statistics'
    threshold."""
    sa, sb = move_samples(runs_a), move_samples(runs_b)
    return {k: compare_samples(sa[k], sb[k], power=False) for k in sa}


def load_runs(path, seeds=None):
    """The runs of a run tool's ``--out`` file, those of ``seeds`` only
    when given (in the order of ``seeds``)."""
    with open(path) as f:
        runs = json.load(f)
    if seeds is None:
        return runs
    by_seed = {r['seed']: r for r in runs}
    missing = [s for s in seeds if s not in by_seed]
    if missing:
        raise SystemExit('%s has no run of seeds %s' % (path, missing))
    return [by_seed[s] for s in seeds]


def row_line(k, r):
    """One printed row: n, median and range of each side, U, p, the
    verdict and, where computed, the detectable shifts of side B."""
    line = ('%-17s %5d %5d %12.6g %12.6g-%-12.6g %12.6g %12.6g-%-12.6g '
            '%9.1f %10.3g %-7s'
            % (k, r['n_a'], r['n_b'], r['median_a'], r['range_a'][0],
               r['range_a'][1], r['median_b'], r['range_b'][0],
               r['range_b'][1], r['U'], r['p'],
               'DIFFERS' if r['differs'] else 'same'))
    if 'detectable' in r:
        line += ' %+.2f%% %+.2f%%' % (100 * r['detectable'][0],
                                      -100 * r['detectable'][1])
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('a')
    ap.add_argument('b')
    ap.add_argument('--labels', nargs=2, default=['A', 'B'])
    ap.add_argument('--seeds-a', type=int, nargs='+', default=None)
    ap.add_argument('--seeds-b', type=int, nargs='+', default=None)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    runs_a = load_runs(args.a, args.seeds_a)
    runs_b = load_runs(args.b, args.seeds_b)
    rows = compare(runs_a, runs_b)
    moves = compare_moves(runs_a, runs_b)
    kept = compare_samples(kept_samples(runs_a), kept_samples(runs_b))
    la, lb = args.labels
    print('%s: seeds %s; %s: seeds %s; differs at p < %g / %d'
          % (la, [r['seed'] for r in runs_a], lb,
             [r['seed'] for r in runs_b], ALPHA, M))
    print('%-17s %5s %5s %12s %25s %12s %25s %9s %10s %-7s %s'
          % ('statistic', 'n_' + la[:3], 'n_' + lb[:3], 'median_' + la[:5],
             'range_' + la[:5], 'median_' + lb[:5], 'range_' + lb[:5],
             'U', 'p', 'verdict', 'detectable shift of B (+, -)'))
    for k, r in rows.items():
        print(row_line(k, r))
    print('diagnostics, not counted in the twelve:')
    for k, r in moves.items():
        print(row_line(k, r))
    print(row_line('sigma_rf_kept', kept))
    result = dict(labels=[la, lb], seeds_a=[r['seed'] for r in runs_a],
                  seeds_b=[r['seed'] for r in runs_b], alpha=ALPHA,
                  m=M, rows=rows, moves=moves, sigma_rf_kept=kept,
                  differs=[k for k, r in rows.items() if r['differs']])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
