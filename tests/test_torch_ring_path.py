"""The port's per-chain ring path against the JAX package's, on the CPU.

Off a TPU, and in float64 anywhere, the JAX package builds its evaluator
without the batch path (``bayhunter_tpu/optimizer.py:76-79``): a warm
step solves each chain's dispersion roots with ``surfdisp_roots`` from
the cached roots by a ring that expands until it finds the root, and
each RF target with ``synrf`` at all nsamp/2 + 1 frequencies.  The
port's counterpart is ``build_evaluator(..., use_batch_swd=False)``:
``Evaluator.eval_full`` over ``swd.surfdisp_roots_warm`` (the blocked
``swd.ring_brackets``), K6 and K3 at all lanes; its float64 twins are
held here to the JAX float64 per-chain path, jitted and vmapped over
the grown models of ``gates.grown_models``:

  * ``ring_brackets`` against ``_ring_brackets`` at ring 1 and 16: the
    same ``found`` and the same ``lo``, lane for lane;
  * ``eval_cold`` and ``eval_full`` at rings 1 and 16 on a death and a
    vs proposal set of 8 chains: roots within ``ROOT_TOL``, the RF
    within ``RF_TOL``, logL within ``LOGL_RTOL``, the valid flags equal;
    and ``convert.state_from_numpy`` of the float64 JAX state;
  * the float32 ring path on the 32 death proposals of
    ``tests/test_torch_dim_ring.py``, of which the batch path's capped
    walk rejects a dozen: no forward reject, and its roots within that
    file's max 5e-4 / p90 2e-5 of the JAX float32 ring's roots.
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bayhunter_tpu import Targets as JTargets
from bayhunter_tpu.ops import swd as jswd
from bayhunter_tpu.ops.voronoi import voronoi_to_layers as jvoronoi
from bayhunter_tpu.sampler import chain as jchain
from bayhunter_tpu.sampler.evaluator import build_evaluator as jbuild
from bayhunter_tpu_torch import bench_config, convert, gates
from bayhunter_tpu_torch.ops import swd, voronoi
from bayhunter_tpu_torch.sampler import chain

NL = 21
C = 8
ROOT_TOL = 1e-8      # km/s
RF_TOL = 1e-9
LOGL_RTOL = 1e-8
# tests/test_torch_dim_ring.py's chains and the phase-root tolerance
DIM_C = 32
RING_MAX, RING_P90 = 5e-4, 2e-5

_JAX = {}


def _jax_evaluator():
    """The JAX float64 per-chain evaluator of ``bench_config``'s
    tutorial configuration (Rayleigh phase + P-RF) and its jitted,
    vmapped ``eval_cold`` and ``eval_full`` at rings 1 and 16, built
    once in a process."""
    if not _JAX:
        targets = []
        for ref in bench_config.CONFIGS['tutorial']:
            obs = np.loadtxt(os.path.join(bench_config.FIXTURES,
                                          'st3_%s.dat' % ref))
            cls = getattr(JTargets, bench_config.TARGETS[ref].__name__)
            targets.append(cls(obs[:, 0], obs[:, 1]))
        ej = jbuild(JTargets.JointTarget(targets=targets),
                    bench_config.PRIORS, bench_config.initparams(2000), NL,
                    dtype=jnp.float64, use_batch_swd=False)
        _JAX['cold'] = jax.jit(jax.vmap(ej.eval_cold))
        for ring in (1, 16):
            _JAX[ring] = jax.jit(jax.vmap(
                lambda vs, z, n, vpvs, noise, cache, cell, ring=ring:
                ej.eval_full(vs, z, n, vpvs, noise, cache, cell,
                             ring_width=ring)))
    return _JAX


def _grown(dtype):
    """The port's ring-path sampler at ``dtype`` and a state of C grown
    models evaluated cold."""
    sp, _ = bench_config.build_config('tutorial', 'cpu', 2000, NL, dtype,
                                      use_batch_swd=False)
    st, gen = sp.init_states_host(0, C)
    st, valid = gates._with_models(sp, st, *gates.grown_models(C, NL))
    assert bool(valid.all())
    return sp, st, gen


def _check_eval(got, want):
    logL, misfits, valid, cache = got
    assert np.array_equal(valid.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(cache[0][1].numpy(), np.asarray(want[3][0][1]),
                               rtol=0, atol=ROOT_TOL)
    np.testing.assert_allclose(cache[0][0].numpy(), np.asarray(want[3][0][0]),
                               rtol=0, atol=ROOT_TOL)
    np.testing.assert_allclose(cache[1][0].numpy(), np.asarray(want[3][1][0]),
                               rtol=0, atol=RF_TOL)
    np.testing.assert_allclose(logL.numpy(), np.asarray(want[0]),
                               rtol=LOGL_RTOL)
    np.testing.assert_allclose(misfits.numpy(), np.asarray(want[1]),
                               rtol=LOGL_RTOL)


def test_ring_brackets_match_jax():
    dt = torch.float64
    VS, Z, N = gates.grown_models(C, NL)
    layers = voronoi.voronoi_to_layers(
        torch.tensor(VS, dtype=dt), torch.tensor(Z, dtype=dt),
        torch.tensor(N), torch.full((C,), 1.73, dtype=dt))
    periods = np.linspace(1.0, 41.0, 21)
    _, _, roots, _ = swd.surfdisp_roots_cold(*layers, periods)
    # previous roots from a fraction of a step to 0.6 km/s away, both
    # ways: one trip, several blocks, and lanes that end at the range
    rs = np.random.RandomState(7)
    shift = rs.choice([-1, 1], roots.shape) * rs.uniform(
        0.0, 1.0, roots.shape) ** 3 * 0.6
    cm, betmx = (x[:, None] for x in swd.lower_bound(layers[1], layers[2],
                                                     dim=-1))
    c_prev = torch.minimum(torch.maximum(roots + torch.tensor(shift), cm),
                           betmx)
    omega = swd.angular_frequencies(periods, 'cpu', dt).expand(C, -1)

    def secular(c, om, rows=None):
        lay = layers if rows is None else tuple(x[rows] for x in layers)
        return swd.secular_at(c, om, *lay, 2)

    def jring(om, cp, cm_, bm, h, vp, vs, rho, K):
        water = vs[0] <= 0.0
        return jswd._ring_brackets(
            om, cp, cm_, bm,
            lambda w, o: jswd.dltar4(w, o, h, vp, vs, rho, water), K,
            (swd.KBLOCK * swd.NBLOCKS) // K, jnp.float64)

    for K in (1, 16):
        lo, found = swd.ring_brackets(omega, c_prev, cm, betmx, secular, K,
                                      (swd.KBLOCK * swd.NBLOCKS) // K)
        jlo, jfound = jax.jit(jax.vmap(
            lambda *a, K=K: jring(*a, K)))(
            *(jnp.asarray(x.numpy()) for x in (omega, c_prev, cm[:, 0],
                                                betmx[:, 0]) + layers))
        assert np.array_equal(found.numpy(), np.asarray(jfound))
        assert np.array_equal(lo.numpy(), np.asarray(jlo))
        assert int(found.sum()) > 0.9 * found.numel()


def test_eval_cold_and_full_match_jax_in_float64():
    fns = _jax_evaluator()
    sp, st, gen = _grown(torch.float64)
    cell = np.zeros(C, np.int32)
    base = (st.vs.numpy(), st.z.numpy(), st.n.numpy(), st.vpvs.numpy(),
            st.noise.numpy())
    jcold = fns['cold'](*base, cell)
    _check_eval(sp.ev.eval_cold(st.vs, st.z, st.n, st.vpvs, st.noise), jcold)
    # the float64 JAX state carried into a float64 port state
    jstate = jchain.ChainState(
        key=jnp.zeros((C, 2), jnp.uint32), vs=base[0], z=base[1],
        n=base[2], vpvs=base[3], noise=base[4], logL=jcold[0],
        misfits=jcold[1], propdist=np.tile(st.propdist[0].numpy(), (C, 1)),
        accepted=np.zeros((C, 5), np.int32),
        proposed=np.zeros((C, 5), np.int32),
        iiter=np.full(C, -2000, np.int32), cache=jcold[3], cell=cell,
        fwdfail=np.zeros((C, 5), np.int32), beta=np.ones(C))
    ported = convert.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), 'cpu', torch.float64)
    assert ported.vs.dtype == ported.cache[0][1].dtype == torch.float64
    assert np.array_equal(ported.logL.numpy(), np.asarray(jcold[0]))
    assert np.array_equal(ported.cache[1][0].numpy(),
                          np.asarray(jcold[3][1][0]))
    # a death and a vs proposal set, evaluated warm from the JAX cache
    for move in (chain.MOVE_DIM, chain.MOVE_VS):
        draws = sp.draw(gen, st, move)
        if move == chain.MOVE_DIM:
            draws['coin'] = torch.zeros_like(draws['coin'])    # deaths
            prop = sp.propose_dim_T(st, st.vs.T, st.z.T, draws)
        else:
            draws['normal'] = draws['normal'] * 4.0
            prop = sp.propose_T(st, st.vs.T, st.z.T, move, draws)
        vs, z = (x.T.contiguous() for x in (prop['vs_t'], prop['z_t']))
        for ring in (1, 16):
            want = fns[ring](vs.numpy(), z.numpy(), prop['n'].numpy(),
                             base[3], base[4], jcold[3], cell)
            got = sp.ev.eval_full(vs, z, prop['n'], ported.vpvs,
                                  ported.noise, ported.cache, ring)
            _check_eval(got, want)
            assert bool(got[2].all())


def test_float32_ring_path_solves_the_dim_proposals():
    sp = gates.pin_sampler('cpu')
    st, gen = sp.init_states_host(0, DIM_C)
    st, valid = gates._with_models(sp, st,
                                   *gates.grown_models(DIM_C, sp.nl))
    draws = sp.draw(gen, st, chain.MOVE_DIM)
    draws['coin'] = torch.zeros_like(draws['coin'])       # deaths
    prop = sp.propose_dim_T(st, st.vs.T, st.z.T, draws)
    args = (prop['vs_t'].contiguous(), prop['z_t'].contiguous(), prop['n'],
            st.vpvs, st.noise, st.cache)
    _, _, batch_valid, _, _ = sp.ev.eval_full_batch_t(
        *args, chain.WARM[chain.MOVE_DIM], st.cell)
    assert int((~batch_valid).sum()) >= 3       # the capped walk's rejects
    # the same proposals on the float32 ring path at the dimension ring
    ring_ev = bench_config.build_config('tutorial', 'cpu', gates.PIN_ITERS,
                                        sp.nl, use_batch_swd=False)[1]
    vs, z = (x.T.contiguous() for x in args[:2])
    _, _, valid, cache = ring_ev.eval_full(
        vs, z, prop['n'], st.vpvs, st.noise, st.cache,
        chain.RING[chain.MOVE_DIM], st.cell)
    assert bool(valid.all())
    spec = sp.ev.specs[0]
    periods = jnp.asarray(spec.periods)

    def jring(vs, z, n, vpvs, c_prev):
        h, vp, vs_l, rho = jvoronoi(vs, z, n, vpvs)
        return jswd.surfdisp_roots(h, vp, vs_l, rho, periods, c_prev=c_prev,
                                   warm_halfwidth=chain.RING[chain.MOVE_DIM])

    _, err, roots = jax.jit(jax.vmap(jring))(
        *(jnp.asarray(x.numpy()) for x in (vs, z, prop['n'], st.vpvs,
                                            st.cache[0][1])))
    assert not np.asarray(err).any()
    d = np.abs(cache[0][1].numpy() - np.asarray(roots))
    print('float32 ring path against the JAX ring: max', d.max(), 'p90',
          np.quantile(d, 0.9))
    assert d.max() < RING_MAX and np.quantile(d, 0.9) < RING_P90
