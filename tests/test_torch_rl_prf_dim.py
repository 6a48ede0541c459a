"""Forward rejects of ``tutorial_rl_prf`` right after initialisation:
one mixed cycle (vs, z, dim, dim, noise) from the initial states of 64
chains (NL = 8) in the port and in the JAX package's ``cycle_mixed_fn``,
with
the JAX chains' randoms injected (helpers in test_torch_sampler.py).

The initial models have one or two layers.  Their Love roots move
further under a birth or death than the dimension moves' capped warm
walk reaches (``swd.WARM_DIM``: ring 1, cap 2), so close to half of
those proposals fail the forward solve, in the reference as in the
port; the port must reject exactly the proposals the reference
rejects."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from conftest import run_isolated  # noqa: E402

C = 64
NL = 8


def test_dim_rejects_from_init_match_jax_rl_prf():
    if run_isolated('tests/test_torch_rl_prf_dim.py::'
                    'test_dim_rejects_from_init_match_jax_rl_prf'):
        return
    import jax
    import jax.numpy as jnp
    from bayhunter_tpu_torch import convert
    from test_torch_sampler import jax_draws, samplers

    sj, _, sp = samplers('tutorial_rl_prf', nl=NL)
    st = sj.init_states_host(0, C)
    ps = convert.state_from_numpy(st, 'cpu')
    keys = st.key
    zmin, zmax = sp.cfg.z_prior
    for move in sp.late_order:
        keys, draws = jax_draws(keys, ps.n.numpy(), move, zmin, zmax,
                                len(sp.cfg.noiseinds))
        ps = sp.step(ps, move, draws)
    js = sj.cycle_mixed_fn(jax.tree.map(jnp.copy, st))
    for f in ('n', 'accepted', 'proposed', 'fwdfail'):
        assert np.array_equal(getattr(ps, f).numpy(),
                              np.asarray(getattr(js, f))), f
    failed = ps.fwdfail.numpy().sum(axis=0)
    proposed = ps.proposed.numpy().sum(axis=0)
    print('proposed', proposed.tolist(), 'forward rejects', failed.tolist())
    assert 0.25 < failed[2] / proposed[2] < 0.75
