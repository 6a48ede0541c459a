"""The mixed cycle (vs, z, dim, dim, noise) of ``tutorial_rl_prf`` in
the port vs the JAX package's ``cycle_mixed_fn`` from the same grown
states and randoms, 12 chains, NL = 8 (helpers in
test_torch_sampler.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from conftest import run_isolated  # noqa: E402


def test_mixed_cycle_matches_jax_rl_prf():
    if run_isolated('tests/test_torch_rl_prf_cycle.py::'
                    'test_mixed_cycle_matches_jax_rl_prf'):
        return
    from test_torch_sampler import compare_cycle
    compare_cycle(late=True, love=True, nl=8)
