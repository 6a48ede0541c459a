"""The mixed cycle (vs, z, dim, dim, noise) of ``tutorial_prf_srf`` in
the port vs the JAX package's ``cycle_mixed_fn`` from the same grown
states and randoms, 12 chains, NL = 8 (helpers in
test_torch_sampler.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from conftest import run_isolated  # noqa: E402


def test_mixed_cycle_matches_jax_prf_srf():
    if run_isolated('tests/test_torch_prf_srf_cycle.py::'
                    'test_mixed_cycle_matches_jax_prf_srf'):
        return
    from test_torch_sampler import compare_cycle
    compare_cycle(late=True, config='tutorial_prf_srf', nl=8)
