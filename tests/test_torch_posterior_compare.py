"""The comparison of two sets of tutorial runs
(``tools/posterior_compare.py``) on fabricated files and samples:

  * ``chain_stats`` on a few ``c%03d_p2*.npy`` sets: the changed-state
    share counts exactly the rows whose model, noise or vp/vs differ
    from the row before (NaN equal to NaN), the nuclei are the finite
    velocities of a NaN-padded model, as ``chip_smoke.
    recovery_summary`` counts them, and the medians are the columns'
    (sigma_RF noise column 3, sigma_SWD column 1);
  * the Mann-Whitney comparison on seeded numpy samples: two draws from
    one distribution are not flagged, a 3 % shift of 126 samples (21
    chains x 6 seeds) against 336 (x 16) is, a statistic equal on
    every seed of both sides is not; the detectable shift is flagged
    when applied; and the tool's command line on two run files, seeds
    selected, with the per-move diagnostics and the kept chains'
    sigma_RF.

No JAX and no child process: numpy and scipy only, plus the port's
outlier rule through ``chip_smoke.recovery_summary``.
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import json
import os
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tools'))

import chip_smoke  # noqa: E402
import posterior_compare as pc  # noqa: E402

NL = 6           # layer slots: models are (n, 2 * NL), vs then depths


def _row(vs, z, noise=(0.98, 0.011, 0.0, 0.005), vpvs=1.73):
    """One snapshot: the velocities and depths NaN-padded to NL slots."""
    pad = [np.nan] * (NL - len(vs))
    return (np.array(list(vs) + pad + list(z) + pad, np.float32),
            np.array(noise, np.float32), np.float32(vpvs))


# a chain's rows and which of rows 1.. differ from the row before: a
# repeat, a noise-only change, a birth (a NaN slot filled), a repeat of
# the NaN-padded model, a vp/vs-only change, a death, a repeat
ROWS = [
    _row([3.0, 3.5], [0.0, 10.0]),
    _row([3.0, 3.5], [0.0, 10.0]),
    _row([3.0, 3.5], [0.0, 10.0], noise=(0.98, 0.012, 0.0, 0.005)),
    _row([3.0, 3.5, 4.0], [0.0, 10.0, 30.0],
         noise=(0.98, 0.012, 0.0, 0.005)),
    _row([3.0, 3.5, 4.0], [0.0, 10.0, 30.0],
         noise=(0.98, 0.012, 0.0, 0.005)),
    _row([3.0, 3.5, 4.0], [0.0, 10.0, 30.0],
         noise=(0.98, 0.012, 0.0, 0.005), vpvs=1.74),
    _row([3.0, 4.0], [0.0, 30.0], noise=(0.98, 0.012, 0.0, 0.005),
         vpvs=1.74),
    _row([3.0, 4.0], [0.0, 30.0], noise=(0.98, 0.012, 0.0, 0.005),
         vpvs=1.74),
]
CHANGED = [False, True, True, False, True, True, False]


def _write_chain(path, c, rows, likes):
    models, noise, vpvs = (np.stack([r[i] for r in rows]) for i in range(3))
    for k, a in (('models', models), ('noise', noise), ('vpvs', vpvs),
                 ('likes', np.asarray(likes, np.float32))):
        np.save(os.path.join(path, 'c%.3d_p2%s.npy' % (c, k)), a)


def test_chain_stats_counts_changed_rows_and_nuclei(tmp_path):
    # chain 0: ROWS; chain 1: ROWS in reverse (the same changes, read
    # backwards); chain 2: one state throughout
    _write_chain(tmp_path, 0, ROWS, np.arange(8.0))
    _write_chain(tmp_path, 1, ROWS[::-1], np.arange(8.0))
    _write_chain(tmp_path, 2, [ROWS[3]] * 8, np.full(8, 2.5))
    st = pc.chain_stats(str(tmp_path), 3, NL)
    assert set(st) == set(pc.PER_CHAIN)
    assert st['changed_share'] == [sum(CHANGED) / 7.0, sum(CHANGED) / 7.0,
                                   0.0]
    nuclei = [2, 2, 2, 3, 3, 3, 2, 2]
    assert st['nuclei_mean'] == [np.mean(nuclei), np.mean(nuclei), 3.0]
    assert st['sigma_swd'] == [np.float32(0.012)] * 3
    assert st['sigma_rf'] == [np.float32(0.005)] * 3
    assert st['vpvs'] == [float(np.median([r[2] for r in ROWS]))] * 2 \
        + [np.float32(1.73)]
    assert st['logl'] == [3.5, 3.5, 2.5]


def test_chain_stats_nuclei_as_recovery_summary(tmp_path):
    # equal likelihoods everywhere: the outlier rule keeps every chain
    # and the better half is every row, so the recovery summary's
    # nucleus histogram is the pooled rows' and its mean the mean of the
    # per-chain means (chains of equal length)
    rng = np.random.default_rng(15)
    for c in range(3):
        rows = [ROWS[i] for i in rng.integers(0, len(ROWS), 16)]
        _write_chain(tmp_path, c, rows, np.full(16, -1.0))
    st = pc.chain_stats(str(tmp_path), 3, NL)
    view = types.SimpleNamespace(savepath=str(tmp_path), maxlayers=NL,
                                 nchains=3)
    summ = chip_smoke.recovery_summary(view)
    assert summ['chains_kept'] == 3
    mean = sum(k * p for k, p in summ['nlay_hist'].items())
    assert mean == pytest.approx(np.mean(st['nuclei_mean']), abs=1e-12)


def test_compare_flags_a_three_percent_shift_only():
    rng = np.random.default_rng(20261018)
    m = len(pc.PER_SEED) + len(pc.PER_CHAIN)
    assert pc.M == m == 12

    def draw(n, shift=1.0):
        return 0.0053 * shift * (1.0 + 0.015 * rng.standard_normal(n))

    same = pc.compare_samples(draw(126), draw(336))
    assert not same['differs'] and same['p'] > 0.01 / m
    # the shift the test would see on these samples, each way: about
    # 3.3 standard errors of the difference in location, 0.5 %
    up, down = same['detectable']
    assert 0.002 < up < 0.01 and 0.002 < down < 0.01
    assert pc.compare_samples(draw(126),
                              draw(336) * (1 + 2 * up))['differs']
    shifted = pc.compare_samples(draw(126, 1.03), draw(336))
    assert shifted['differs'] and shifted['p'] < 0.01 / m
    assert (shifted['n_a'], shifted['n_b']) == (126, 336)
    assert shifted['median_a'] > shifted['median_b']
    # a statistic equal on every seed of both sides: all ties, p = 1
    ties = pc.compare_samples(np.full(6, 5.0), np.full(16, 5.0))
    assert ties['p'] == 1.0 and not ties['differs']


def _runs(rng, seeds, rf_shift=1.0):
    """Fabricated run-tool objects: per-seed values and 21 chains each,
    sigma_RF scaled by ``rf_shift``."""
    runs = []
    for s in seeds:
        def noisy(v, n=None):
            return v * (1.0 + 0.015 * rng.standard_normal(n))
        nkept = int(rng.integers(6, 19))
        r = dict(seed=s, chains_kept=nkept,
                 kept=sorted(rng.choice(21, nkept, replace=False).tolist()),
                 nlay_mode=5,
                 p56=float(rng.uniform(0.5, 1.0)),
                 sigma_rf_median=float(noisy(0.0053 * rf_shift)),
                 sigma_swd_median=float(noisy(0.0111)),
                 vpvs_median=float(noisy(1.73)))
        r['per_chain'] = dict(
            sigma_rf=noisy(0.0053 * rf_shift, 21).tolist(),
            sigma_swd=noisy(0.0111, 21).tolist(),
            vpvs=noisy(1.73, 21).tolist(), logl=noisy(-300.0, 21).tolist(),
            nuclei_mean=noisy(5.5, 21).tolist(),
            changed_share=noisy(0.3, 21).tolist())
        r['moves'] = dict(accept_pct=noisy(np.array([60., 93., 5., 47., 78.]),
                                           5).tolist(),
                          fwd_reject_pct=[0., 0., float(noisy(20.)), 0., 0.],
                          propdist_median=[0.035, 0.035, 0.0105, 0.0059,
                                           0.007])
        runs.append(r)
    return runs


def test_compare_command_line(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(7)
    a, b = tmp_path / 'a.json', tmp_path / 'b.json'
    a.write_text(json.dumps(_runs(rng, range(1, 7), rf_shift=1.03)))
    b.write_text(json.dumps(_runs(rng, range(1, 17))))
    out = tmp_path / 'cmp.json'
    monkeypatch.setattr(sys, 'argv', [
        'posterior_compare.py', str(a), str(b), '--labels', 'JAX', 'port',
        '--out', str(out)])
    pc.main()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res == json.loads(out.read_text())
    assert res['m'] == 12 and res['seeds_b'] == list(range(1, 17))
    assert 'sigma_rf' in res['differs']
    assert set(res['differs']) <= {'sigma_rf', 'sigma_rf_median'}
    assert res['rows']['sigma_rf']['n_a'] == 126
    assert res['rows']['sigma_rf']['n_b'] == 336
    # the per-move diagnostics: one sample a seed, not counted in m
    assert set(res['moves']) == {'accept_' + k for k in pc.MOVES} | {
        'width_' + k for k in pc.MOVES} | {'fwd_reject_dim'}
    assert res['moves']['accept_dim']['n_a'] == 6
    assert not res['moves']['fwd_reject_dim']['differs']
    # the kept chains' sigma_RF: the chains each seed's outlier rule kept
    kept_a = sum(r['chains_kept'] for r in json.loads(a.read_text()))
    assert res['sigma_rf_kept']['n_a'] == kept_a
    assert len(res['sigma_rf_kept']['detectable']) == 2
    # the null control's form: one file's seeds 1-8 against its 9-16
    monkeypatch.setattr(sys, 'argv', [
        'posterior_compare.py', str(b), str(b), '--seeds-a',
        *map(str, range(1, 9)), '--seeds-b', *map(str, range(9, 17))])
    pc.main()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res['differs'] == []
    assert res['rows']['logl']['n_a'] == res['rows']['logl']['n_b'] == 168
    monkeypatch.setattr(sys, 'argv', [
        'posterior_compare.py', str(a), str(b), '--seeds-a', '7'])
    with pytest.raises(SystemExit):
        pc.main()
