"""Why a JAX run of the tutorial on the CPU records no forward reject
where the port rejects a share of the dimension proposals.

The port's dimension moves solve their dispersion roots with the JAX
package's batch path (``swd.WARM_DIM``: a Newton prepass, then a warm
walk of ring 1 and cap 2), and reject a proposal whose root lies beyond
the walk's bound; ``tests/test_torch_cycle.py::
test_mixed_cycle_matches_jax`` holds those rejects equal, chain by
chain, to the JAX batch path's (its Pallas kernels in interpret mode).
Off a TPU the JAX optimizer builds its evaluator without the batch
path (``bayhunter_tpu/optimizer.py:78-79``), and a dimension step
solves each chain with ``surfdisp_roots`` from its warm roots at ring
1 (``bayhunter_tpu/sampler/chain.py:1271-1281``), which expands its
ring until it finds the root (``bayhunter_tpu/ops/swd.py`` ``surfdisp_roots``).

Here one death step of 32 grown chains of the dimension-reject pin's
configuration (``gates.dim_reject_pin``) runs on the port's CPU twins.
The JAX row-major solve, from the same warm roots at ring 1, finds the
root of every proposal, the ones the port rejects among them. On those
it agrees with the port's cold solve within the phase-root tolerance
(``tests/test_torch_love.py``: p90 2e-5, max 5e-4).
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bayhunter_tpu.ops import swd as jswd
from bayhunter_tpu.ops.voronoi import voronoi_to_layers
from bayhunter_tpu_torch import gates
from bayhunter_tpu_torch.sampler import chain

C = 32
DIM_RING = 1        # _ring_width_for(MOVE_BIRTH), chain.py:483-485


def test_jax_cpu_ring_solves_the_dim_proposals_the_port_rejects():
    sp = gates.pin_sampler('cpu')
    st, gen = sp.init_states_host(0, C)
    st, valid = gates._with_models(sp, st, *gates.grown_models(C, sp.nl))
    assert bool(valid.all())
    draws = sp.draw(gen, st, chain.MOVE_DIM)
    draws['coin'] = torch.zeros_like(draws['coin'])       # deaths
    prop = sp.propose_dim_T(st, st.vs.T, st.z.T, draws)
    _, _, fvalid, _, mvalid = sp.ev.eval_full_batch_t(
        prop['vs_t'].contiguous(), prop['z_t'].contiguous(), prop['n'],
        st.vpvs, st.noise, st.cache, chain.WARM[chain.MOVE_DIM], st.cell)
    assert bool(mvalid.all())
    rejected = (~fvalid).numpy()
    print('port forward rejects', int(rejected.sum()), 'of', C)
    assert rejected.sum() >= 3

    vs, z = (x.T.contiguous() for x in (prop['vs_t'], prop['z_t']))
    spec = sp.ev.specs[0]
    assert spec.kind == 'swd' and spec.iwave == 2 and not spec.igr
    periods = jnp.asarray(spec.periods)

    def ring(vs, z, n, vpvs, c_prev):
        h, vp, vs_l, rho = voronoi_to_layers(vs, z, n, vpvs)
        return jswd.surfdisp_roots(h, vp, vs_l, rho, periods, c_prev=c_prev,
                                   warm_halfwidth=DIM_RING)

    _, err, roots = jax.jit(jax.vmap(ring))(
        *(jnp.asarray(x.numpy()) for x in (vs, z, prop['n'], st.vpvs,
                                            st.cache[0][1])))
    assert not np.asarray(err).any()

    idx = torch.from_numpy(np.flatnonzero(rejected))
    _, _, cold_valid, cold = sp.ev.eval_cold(
        vs[idx], z[idx], prop['n'][idx], st.vpvs[idx], st.noise[idx],
        st.cell[idx])
    assert bool(cold_valid.all())
    d = np.abs(np.asarray(roots)[rejected] - cold[0][1].numpy())
    print('ring against the port cold solve: max', d.max(),
          'p90', np.quantile(d, 0.9))
    assert d.max() < 5e-4 and np.quantile(d, 0.9) < 2e-5
