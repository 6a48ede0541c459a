"""The chain split (``bayhunter_tpu_torch/parallel/mesh.py``) against the
JAX package's ``parallel/mesh.py`` and against the one-device run, on
the CPU:

  * (a) ``pad_chains`` equals the JAX ``pad_chains`` over a grid of
    (nchains, ndev); ``chain_sharding`` gives contiguous blocks of whole
    temperature groups, as even as the groups allow, and raises for
    fewer groups than devices; ``devices`` and ``device`` together
    raise;
  * (b) the block-wise resort equals the JAX ``resort_states(states,
    perm0, 1, mesh)`` on 8 CPU devices, on the inputs of
    ``tests/test_sharding8.py:204-241``: the same ``perm`` and ``n``;
  * blocks of the tutorial's Rayleigh phase + P-RF batch, evaluated in
    this process, step for step equal to the whole batch: each block's
    matrix products and cold chunks round every chain as the whole
    batch's do;
  * (c) ``test_sharding8.py:32-68`` in the port: 16 chains of the tiny
    SWD problem over 8 spawned workers (``['cpu'] * 8``), one segment
    across the early/late cutoff, every state field equal bit for bit
    to the run in this process;
  * (e) the MULTICHIP dry run (``__graft_entry__.py:87-142``) in the
    port: 16 chains in 8 groups of 2 rungs over the 8 workers, sweeps
    proposed, equal to the run in this process, swap counters included;
  * (g) the workers start from ``spawn``; a worker that raises, one
    built on a bad device, one that exits without an answer and one
    that gives none in time each raise in the parent;
  * (h), on a card, is in ``tests/test_torch_mesh_runs.py``, which
    imports no jax.

One pool of 8 workers serves (c), (e) and (g).
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_mesh_workers as tmw  # noqa: E402
from bayhunter_tpu.parallel import mesh as jmesh  # noqa: E402
from bayhunter_tpu.sampler import chain as jchain  # noqa: E402
from bayhunter_tpu_torch import MCMC_Optimizer, bench_config  # noqa: E402
from bayhunter_tpu_torch import convert  # noqa: E402
from bayhunter_tpu_torch.parallel import (TomoInversion,  # noqa: E402
                                          chain_sharding, mesh,
                                          shard_states)
from bayhunter_tpu_torch.sampler import chain, evaluator  # noqa: E402

NCH = 16
NDEV = 8


def in_process(ntemps=1):
    return tmw.in_process(NCH, ntemps)


def split(pool, ntemps=1):
    return tmw.split(pool, NCH, ntemps)


assert_same = tmw.assert_same


@pytest.fixture(scope='module')
def pool():
    """8 workers of the tiny problem, 2 chains each: one temperature
    group each under 2 rungs."""
    blocks = chain_sharding(NCH, ['cpu'] * NDEV, group=2)
    workers = mesh.Workers(['cpu'] * NDEV, blocks, tmw.TinyRun)
    yield workers
    workers.terminate()


# ----------------------------------------------------------------------
# (a) padding and blocks
# ----------------------------------------------------------------------

def test_pad_chains_and_blocks_match_jax():
    for ndev in (1, 2, 3, 4, 7, 8):
        devs = ['cpu'] * ndev
        for nchains in (1, 2, 5, 8, 16, 21, 100, 10240):
            assert mesh.pad_chains(nchains, devs) == \
                jmesh.pad_chains(nchains, list(range(ndev))), (nchains, ndev)
            for group in (1, 2, 4):
                if nchains % group or nchains // group < ndev:
                    with pytest.raises(ValueError):
                        chain_sharding(nchains, devs, group)
                    continue
                blocks = chain_sharding(nchains, devs, group)
                sizes = [b.stop - b.start for b in blocks]
                assert blocks[0].start == 0 and blocks[-1].stop == nchains
                assert all(a.stop == b.start
                           for a, b in zip(blocks, blocks[1:]))
                assert all(b.total == nchains for b in blocks)
                # whole groups, as even as the groups allow
                assert all(s % group == 0 and s > 0 for s in sizes)
                assert max(sizes) - min(sizes) <= group
                assert sizes == sorted(sizes, reverse=True)
    # two devices, 4 rungs, 1 chain: JAX pads to 4 and splits the group
    # over both devices; the port refuses
    assert jmesh.pad_chains(4, [0, 1]) == 4
    with pytest.raises(ValueError, match='whole group'):
        chain_sharding(4, ['cpu', 'cpu'], 4)


def test_device_rules():
    x, Y = np.linspace(2, 40, 4), np.ones((2, 4))
    with pytest.raises(ValueError, match='not both'):
        TomoInversion(x, Y, device='cpu', devices=['cpu', 'cpu'])
    targets = tmw.tiny_targets()
    with pytest.raises(ValueError, match='not both'):
        MCMC_Optimizer.without_files(targets, {'nchains': 2}, {},
                                     device='cpu', devices=['cpu'])
    # one entry runs in this process, on that device
    opt = MCMC_Optimizer.without_files(targets, {'nchains': 2}, {},
                                       devices=['cpu'])
    assert opt.devices is None and opt.device.type == 'cpu'
    assert opt.eval_fn is not None
    # two entries split: whole groups of 2 rungs, 3 posterior chains
    opt = MCMC_Optimizer.without_files(
        targets, {'nchains': 3, 'ntemps': 2, 'tmax': 10.0}, {},
        devices=['cpu', 'cpu'])
    assert opt.eval_fn is None and opt.device.type == 'cpu'
    assert [(b.start, b.stop) for b in opt.blocks] == [(0, 4), (4, 6)]
    with pytest.raises(ValueError, match='whole group'):
        MCMC_Optimizer.without_files(targets, {'nchains': 1, 'ntemps': 2},
                                     {}, devices=['cpu', 'cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            MCMC_Optimizer.without_files(targets, {'nchains': 2}, {})


# ----------------------------------------------------------------------
# (b) the block-wise resort
# ----------------------------------------------------------------------

def test_block_resort_matches_jax_sharded_resort(cpu_devices):
    # tests/test_sharding8.py:204-241: 32 chains of the tiny problem
    # from seed 3, n redrawn from RandomState(8), 8 devices
    C = 32
    sampler = tmw.tiny_sampler('cpu')
    states, _ = sampler.init_states_host(3, C)
    rs = np.random.RandomState(8)
    n_in = rs.randint(2, 6, C).astype(np.int32)
    states.n = torch.tensor(n_in)
    host = convert.state_to_numpy(states)
    jstates = jchain.ChainState(
        key=random.split(random.PRNGKey(0), C),
        cache=tuple(tuple(jnp.asarray(a) for a in e) for e in host['cache']),
        **{k: jnp.asarray(host[k]) for k in convert.FLOAT_FIELDS
           + convert.INT_FIELDS})
    jmesh8 = Mesh(np.array(cpu_devices[:NDEV]), ('chains',))
    sharding = NamedSharding(jmesh8, P('chains'))
    jstates = jax.device_put(jstates, sharding)
    perm0 = jax.device_put(jnp.arange(C, dtype=jnp.int32), sharding)
    jout, jperm = jchain.resort_states(jstates, perm0, 1, jmesh8)

    # each worker sorts its own block, its map holding global rows
    blocks = chain_sharding(C, ['cpu'] * NDEV)
    parts, perms = [], []
    for part, r in zip(shard_states(states, blocks), blocks):
        part, perm = chain.resort_states(part, torch.arange(r.start, r.stop))
        parts.append(part)
        perms.append(perm)
    out = mesh.gather_states(parts)
    np.testing.assert_array_equal(torch.cat(perms).numpy(),
                                  np.asarray(jperm))
    np.testing.assert_array_equal(out.n.numpy(), np.asarray(jout.n))
    np.testing.assert_array_equal(out.vs.numpy(), np.asarray(jout.vs))
    np.testing.assert_array_equal(out.n.numpy(), n_in[np.asarray(jperm)])
    # shard_states and gather_states are inverses, numpy fields too
    again = mesh.gather_states(shard_states(states, blocks))
    assert_same(convert.state_to_numpy(again), host)
    assert_same(mesh.concat(shard_states(host, blocks)), host)


# ----------------------------------------------------------------------
# (c) and (e): split runs against the run in this process
# ----------------------------------------------------------------------

def test_blocks_evaluate_as_the_whole_batch(monkeypatch):
    # the tutorial's Rayleigh phase + P-RF under the dof-corrected
    # Gaussian law: a block's matrix products (the law's, the RF DFT's)
    # and its cold chunks (4 rows here, so that blocks straddle them)
    # must round each chain as the whole batch does; three blocks of
    # 16 chains evaluated in this process, step by step
    monkeypatch.setattr(evaluator, 'COLD_CHUNK', 4)
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    priors['layers'] = (1, 7)
    ip.update(nchains=NCH, iter_burnin=24, iter_main=24)

    def run(rows):
        opt = MCMC_Optimizer.without_files(targets, ip, priors, 5,
                                           device='cpu')
        opt.sampler.rows = opt._rows = rows
        return opt, opt._init_states()

    whole, st = run(None)
    blocks = chain_sharding(NCH, ['cpu'] * 3)
    parts = [run(r) for r in blocks]
    assert [(b.start, b.stop) for b in blocks] == [(0, 6), (6, 11),
                                                   (11, 16)]
    assert all(o.eval_fn.rows == r for (o, _), r in zip(parts, blocks))
    sts = [s for _, s in parts]
    opts = [whole] + [o for o, _ in parts]
    # one schedule each, drawn from its own generator as a run draws it
    it = int(whole.sampler.early_cutoff) - 4
    for moves in zip(*(chain.cycle_moves(o.sampler, it, 14, o._gen)
                       for o in opts)):
        assert len(set(moves)) == 1
        assert_same(convert.state_to_numpy(mesh.gather_states(sts)),
                    convert.state_to_numpy(st))
        st = whole.sampler.advance(st, moves[0], whole._gen)
        sts = [o.sampler.advance(s, moves[0], o._gen)
               for o, s in zip(opts[1:], sts)]
    assert_same(convert.state_to_numpy(mesh.gather_states(sts)),
                convert.state_to_numpy(st))


def test_dispatch_cycles_8_workers_match_one_device(pool):
    want = in_process()
    got = split(pool)
    assert_same(got, want)
    assert np.all(np.isfinite(got['logL']))
    assert got['n'].shape == (NCH,) and len(pool.devices) == NDEV


def test_tempered_sweeps_8_workers_match_one_device(pool):
    want = in_process(ntemps=2)
    got = split(pool, ntemps=2)
    assert_same(got, want)
    assert int(got['swap_proposed'].sum()) > 0
    np.testing.assert_array_equal(got['beta'][::2], 1.0)


# ----------------------------------------------------------------------
# (g) failures
# ----------------------------------------------------------------------

def test_spawn_and_a_worker_that_raises(pool):
    assert mesh.context().get_start_method() == 'spawn'
    assert {type(p._popen).__module__ for p in pool._procs} == {
        'multiprocessing.popen_spawn_posix'}
    # a worker's exception is raised here with its traceback; the
    # workers answer the next command
    with pytest.raises(mesh.WorkerError, match='ValueError: from a worker'):
        pool.each(tmw.raises, 'from a worker')
    assert pool.each(int, '7') == [7] * NDEV


def test_workers_that_exit_fail_to_build_or_hang(pool):
    with pytest.raises(mesh.WorkerError, match='exited with code 3'):
        pool.each(os._exit, 3)
    pool.terminate()
    # a worker built on a device that does not exist
    with pytest.raises(mesh.WorkerError, match='worker 0 \\(cuda:99'):
        mesh.Workers(['cuda:99'], chain_sharding(2, ['cuda:99']),
                     tmw.TinyRun)
    # no answer in time: raised after the timeout, not waited out
    t = time.time()
    with pytest.raises(mesh.WorkerError, match='no answer'):
        mesh.Workers(['cpu'], chain_sharding(2, ['cpu']), tmw.slow_build,
                     timeout=1.0)
    assert time.time() - t < 20
