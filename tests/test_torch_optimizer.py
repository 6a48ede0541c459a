"""The port's ``MCMC_Optimizer`` on the CPU against the JAX package's:

  * the ``.npy`` output contract of a run (4 chains, 40 + 40
    iterations, ``maxmodels`` 10, the tutorial's data and priors): the
    file names, dtypes, shapes and bytes that the JAX ``_save_phase``
    writes for the same snapshots; ``_phase_plan`` over a grid;
    ``_snapshot_host`` and ``_publish`` on the same numpy state;
  * snapshots after every ``thin``-th iteration (thin 2, segments of
    50: 25 states, each the trajectory's state at its iteration), and
    the JAX ``_run_phase``'s schedule, which records each segment's last
    state ``segment / thin`` times (its dispatch replaced by a stand-in
    that advances a counter, so no JAX program runs);
  * checkpoint and resume bit for bit equal to an uninterrupted run;
    the resort relabelling undone in the snapshots; parallel tempering
    planned (``ntemps`` 2: two rungs per chain); no device given and no
    CUDA device refused.

The JAX side calls only jit-free host methods (unbound, on a namespace).
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from bayhunter_tpu import optimizer as jopt  # noqa: E402
from bayhunter_tpu_torch import MCMC_Optimizer, Targets  # noqa: E402
from bayhunter_tpu_torch import bench_config, convert  # noqa: E402
from bayhunter_tpu_torch.sampler import chain  # noqa: E402

JAX = jopt.MCMC_Optimizer
NAMES = {'model': 'models', 'logL': 'likes', 'misfits': 'misfits',
         'noise': 'noise', 'vpvs': 'vpvs'}


@pytest.fixture(scope='module')
def tutorial_run(tmp_path_factory):
    """The tutorial's data and priors (vp/vs inverted) at 8 layer slots,
    4 chains, 40 + 40 iterations, maxmodels 10, on the CPU."""
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    priors['layers'] = (1, 7)
    ip.update(nchains=4, iter_burnin=40, iter_main=40, maxmodels=10,
              savepath=str(tmp_path_factory.mktemp('tutorial')))
    opt = MCMC_Optimizer(targets, ip, priors, random_seed=5, device='cpu')
    opt.mp_inversion()
    return opt


def _swd_optimizer(path, **ip):
    """A cheap configuration: Rayleigh phase alone, 8 layer slots."""
    obs = np.loadtxt(os.path.join(bench_config.FIXTURES, 'st3_rdispph.dat'))
    targets = Targets.JointTarget([Targets.RayleighDispersionPhase(
        obs[:, 0], obs[:, 1])])
    priors = {'layers': (1, 7), 'vs': (2.0, 5.0), 'vpvs': (1.6, 1.9),
              'swdnoise_sigma': (1e-5, 0.05)}
    params = dict(nchains=4, iter_burnin=30, iter_main=20, maxmodels=10,
                  thickmin=0.1, savepath=str(path))
    params.update(ip)
    return MCMC_Optimizer(targets, params, priors, random_seed=2,
                          device='cpu'), targets, priors, params


def _phase(path, nchains, tag):
    return {key: np.stack([np.load(os.path.join(
        path, 'c%.3d_%s%s.npy' % (c, tag, name))) for c in range(nchains)])
        for key, name in NAMES.items()}


def test_output_contract_matches_jax(tutorial_run, tmp_path):
    opt = tutorial_run
    files = set(os.listdir(opt.savepath))
    assert 'test_config.pkl' in files and 'checkpoint.npz' not in files
    assert chip_smoke.check_contract(opt) == {'p1': 10, 'p2': 10}
    ns = types.SimpleNamespace(nchains=4, savepath=str(tmp_path))
    for tag in ('p1', 'p2'):
        snaps = _phase(opt.savepath, 4, tag)
        JAX._save_phase(ns, snaps, tag)
    jfiles = sorted(os.listdir(tmp_path))
    assert jfiles == sorted(files - {'test_config.pkl'})
    for f in jfiles:
        a = np.load(os.path.join(opt.savepath, f))
        b = np.load(os.path.join(tmp_path, f))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        with open(os.path.join(opt.savepath, f), 'rb') as fa, \
                open(os.path.join(tmp_path, f), 'rb') as fb:
            assert fa.read() == fb.read()
    models = _phase(opt.savepath, 4, 'p2')['model']
    assert models.shape == (4, 10, 16) and np.isnan(models).any()
    vpvs = _phase(opt.savepath, 4, 'p2')['vpvs']
    assert np.all((vpvs >= 1.4) & (vpvs <= 2.1)) and np.unique(vpvs).size > 1


def test_phase_plan_matches_jax():
    for maxmodels in (1, 7, 10, 64, 50000):
        ns = types.SimpleNamespace(initparams={'maxmodels': maxmodels})
        for niter in (0, 1, 9, 10, 11, 40, 99, 2048, 16384, 32768):
            assert MCMC_Optimizer._phase_plan(ns, niter) == \
                JAX._phase_plan(ns, niter), (maxmodels, niter)


def test_snapshot_host_and_publish_match_jax(tutorial_run):
    opt = tutorial_run
    st = opt.final_states
    perm = torch.tensor([2, 0, 3, 1])
    opt._perm = perm
    try:
        port = opt._snapshot_host(st)
    finally:
        opt._perm = None
    host = convert.state_to_numpy(st)
    ns = types.SimpleNamespace(_perm=perm.numpy(), tempering_plan=None,
                               nchains=4)
    want = JAX._snapshot_host(ns, types.SimpleNamespace(**host))
    assert set(port) == set(want)
    for key in want:
        assert port[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(port[key], want[key])

    class Socket:
        def __init__(self):
            self.sent = []

        def send_array(self, arr):
            self.sent.append(arr)

    a, b = Socket(), Socket()
    opt._publish(a, port)
    JAX._publish(ns, b, want)
    assert len(a.sent) == len(b.sent) == 3
    for x, y in zip(a.sent, b.sent):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_snapshots_every_thin_iterations(tmp_path):
    # thin 2 and one segment of 50 iterations: 25 snapshots, each the
    # state after an even iteration of the trajectory that the same
    # sampler, states and generator give step by step
    opt, *_ = _swd_optimizer(tmp_path, maxmodels=25, segment_iters=50,
                             resort_chains=False)
    assert opt._phase_plan(50) == (2, 25, 0)
    states = opt._init_states()
    gen_state = opt._gen.get_state()
    _, snaps = opt._run_phase(states, 50, 'burn-in')
    assert snaps['logL'].shape == (4, 25)
    opt._gen.set_state(gen_state)
    sp, want = opt.sampler, []
    st = states
    for i, move in enumerate(chain.remainder_moves(sp, -30, 50, opt._gen),
                             1):
        st = sp.step(st, move, sp.draw(opt._gen, st, move))
        if i % 2 == 0:
            want.append(opt._snapshot_host(st))
    for key in NAMES:
        np.testing.assert_array_equal(
            snaps[key], np.stack([w[key] for w in want], axis=1))
    # consecutive snapshots are other states, not copies of one
    rows = np.concatenate([snaps['model'], snaps['logL'][..., None],
                           snaps['noise'], snaps['vpvs'][..., None]], -1)
    distinct = sum(not np.array_equal(rows[:, k], rows[:, k + 1],
                                      equal_nan=True) for k in range(24))
    assert distinct >= 20


def test_jax_phase_records_each_segment_end_state_thin_times(monkeypatch):
    # the JAX _run_phase (bayhunter_tpu/optimizer.py:230-307) with its
    # dispatch replaced by a counter: thin 10 and segments of 50 record
    # each segment's last state five times, where the reference saves
    # the state after every 10th iteration
    C, nl = 3, 4

    def state(it):
        def f(v, shape=(C,)):
            return np.full(shape, v, np.float32)
        return types.SimpleNamespace(
            vs=f(3.0, (C, nl)), z=f(1.0, (C, nl)), n=np.full(C, 2, np.int32),
            logL=f(it), misfits=np.zeros((C, 2), np.float32),
            noise=np.zeros((C, 2), np.float32), vpvs=f(1.7),
            iiter=np.full(C, it, np.int32),
            accepted=np.zeros((C, 5), np.int32),
            proposed=np.ones((C, 5), np.int32),
            fwdfail=np.zeros((C, 5), np.int32))

    monkeypatch.setattr(jopt, 'dispatch_cycles',
                        lambda sampler, st, it, count: state(it + count))
    ns = types.SimpleNamespace(
        initparams={'maxmodels': 10, 'segment_iters': 50,
                    'checkpoint_seconds': 0},
        sampler=types.SimpleNamespace(step_fn=None, cycle_fn=object(),
                                      cycle_len=5),
        tempering_plan=None, _resort=False, _perm=None, nchains=C,
        maxlayers=nl, _precompiled=True)
    ns._phase_plan = types.MethodType(JAX._phase_plan, ns)
    ns._snapshot_host = types.MethodType(JAX._snapshot_host, ns)
    _, snaps = JAX._run_phase(ns, state(-100), 100, 'burn-in', t0=0.0)
    assert snaps['logL'][0].tolist() == [-50.0] * 5 + [0.0] * 5
    # the port's schedule: the iterations -90, -80, ..., 0
    assert [-100 + 10 * k for k in range(1, 11)] == list(range(-90, 1, 10))


def test_jax_phase_one_iteration_segments_record_each_state_once(
        monkeypatch):
    # the premise of tools/jax_tutorial_runs.py's pin: the JAX _run_phase
    # with segment_iters 1 and thin 1 (below a cycle, so per-step
    # dispatch) records the state after every iteration exactly once,
    # and asks the move schedule for each global iteration once, in order
    C, nl = 3, 4

    def state(it):
        def f(v, shape=(C,)):
            return np.full(shape, v, np.float32)
        return types.SimpleNamespace(
            vs=f(3.0, (C, nl)), z=f(1.0, (C, nl)), n=np.full(C, 2, np.int32),
            logL=f(it), misfits=np.zeros((C, 2), np.float32),
            noise=np.zeros((C, 2), np.float32), vpvs=f(1.7),
            iiter=np.full(C, it, np.int32),
            accepted=np.zeros((C, 5), np.int32),
            proposed=np.ones((C, 5), np.int32),
            fwdfail=np.zeros((C, 5), np.int32))

    asked = []

    def moves_for(it, count):
        asked.extend(range(it, it + count))
        return np.zeros(count, np.int32)

    def dispatch_cycles(*args):
        raise AssertionError('thin 1 is below a cycle: no fused cycles')

    monkeypatch.setattr(jopt, 'dispatch_cycles', dispatch_cycles)
    ns = types.SimpleNamespace(
        initparams={'maxmodels': 50, 'segment_iters': 1,
                    'checkpoint_seconds': 0},
        sampler=types.SimpleNamespace(
            step_fn=lambda st, move: state(int(st.iiter[0]) + 1),
            moves_for=moves_for, cycle_fn=object(), cycle_len=5),
        tempering_plan=None, _resort=False, _perm=None, nchains=C,
        maxlayers=nl, _precompiled=True)
    ns._phase_plan = types.MethodType(JAX._phase_plan, ns)
    ns._snapshot_host = types.MethodType(JAX._snapshot_host, ns)
    _, snaps = JAX._run_phase(ns, state(-100), 12, 'burn-in', t0=0.0)
    assert snaps['logL'][0].tolist() == [float(it) for it in range(-99, -87)]
    assert asked == list(range(-100, -88))


def test_resume_is_bitwise(tmp_path):
    base, targets, priors, ip = _swd_optimizer(
        tmp_path / 'one', segment_iters=5, checkpoint_seconds=0)
    base.mp_inversion()

    class Stopped(Exception):
        pass

    class StopsAtThird(MCMC_Optimizer):
        written = 0

        def save_checkpoint(self, *a, **kw):
            super().save_checkpoint(*a, **kw)
            StopsAtThird.written += 1
            if StopsAtThird.written == 3:
                raise Stopped

    ip2 = dict(ip, checkpoint_seconds=1e-9, savepath=str(tmp_path / 'two'))
    with pytest.raises(Stopped):
        StopsAtThird(targets, ip2, priors, random_seed=2,
                     device='cpu').mp_inversion()
    with np.load(tmp_path / 'two' / 'data' / 'checkpoint.npz') as ck:
        assert (int(ck['phase']), int(ck['it_done'])) == (1, 15)
        assert ck['parts_logL'].shape == (5, 4)
    again = MCMC_Optimizer(targets, ip2, priors, random_seed=2, device='cpu')
    again.mp_inversion(resume=True)
    assert chip_smoke.same_outputs(base.savepath, again.savepath)
    assert chip_smoke.same_states(torch, base.final_states,
                                  again.final_states)
    assert not os.path.exists(tmp_path / 'two' / 'data' / 'checkpoint.npz')
    # the resort map travelled with the checkpoint
    assert base._perm is not None and torch.equal(base._perm, again._perm)


def test_resort_is_undone_in_snapshots(tutorial_run):
    opt = tutorial_run
    opt._perm = None      # the states' own row order, whatever ran before
    st = opt.final_states
    before = opt._snapshot_host(st)
    perm0 = torch.arange(4)
    sorted_st, perm = chain.resort_states(st, perm0)
    n = sorted_st.n.numpy()
    assert np.all(np.diff(n) >= 0)
    assert torch.equal(perm, torch.argsort(st.n, stable=True))
    assert torch.equal(sorted_st.cache[1][0], st.cache[1][0][perm])
    opt._perm = perm
    try:
        after = opt._snapshot_host(sorted_st)
    finally:
        opt._perm = None
    for key in before:
        np.testing.assert_array_equal(after[key], before[key])


def test_tempering_and_missing_device_are_refused(tmp_path):
    # tempering is ported: ntemps 2 builds a plan, two rungs per chain
    targets, _ = bench_config.tutorial_targets()
    ip = {'nchains': 2, 'savepath': str(tmp_path)}
    opt = MCMC_Optimizer(targets, dict(ip, ntemps=2, tmax=50.0),
                         device='cpu')
    assert opt.tempering_plan.ntemps == 2 and opt.nchains_total == 4
    np.testing.assert_allclose(opt.tempering_plan.betas,
                               [1.0, 0.02, 1.0, 0.02])
    assert opt.sampler.swap_fn is not None and opt.sampler.swap_every == 1
    if torch.cuda.is_available():
        assert MCMC_Optimizer(targets, ip).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            MCMC_Optimizer(targets, ip)
