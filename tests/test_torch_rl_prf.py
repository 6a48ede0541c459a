"""``tutorial_rl_prf`` (Rayleigh phase, Love phase and P-RF targets) in
the port vs the JAX package at 12 chains and NL = 8 (CPU, float32):
initial states, and one early cycle from the JAX package's grown states
carried across with ``convert.state_from_numpy`` (three-target forward
cache included) and the JAX chains' randoms injected.  The mixed cycle
is in test_torch_rl_prf_cycle.py; the helpers in test_torch_sampler.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from conftest import run_isolated  # noqa: E402

NL = 8


def test_init_states_match_jax_rl_prf():
    if run_isolated('tests/test_torch_rl_prf.py::'
                    'test_init_states_match_jax_rl_prf'):
        return
    from test_torch_sampler import compare_init
    ps = compare_init('tutorial_rl_prf', nl=NL)
    assert len(ps.cache) == 3 and ps.misfits.shape[1] == 4


def test_early_cycle_matches_jax_rl_prf():
    if run_isolated('tests/test_torch_rl_prf.py::'
                    'test_early_cycle_matches_jax_rl_prf'):
        return
    from test_torch_sampler import compare_cycle
    compare_cycle(late=False, config='tutorial_rl_prf', nl=NL)
