"""The port's mixed cycle (vs, z, dim, dim, noise with per-chain
birth/death slots) vs the JAX package's ``cycle_mixed_fn`` from the
same grown states and randoms (helpers in test_torch_sampler.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from conftest import run_isolated  # noqa: E402


def test_mixed_cycle_matches_jax():
    if run_isolated('tests/test_torch_cycle.py::'
                    'test_mixed_cycle_matches_jax'):
        return
    from test_torch_sampler import compare_cycle
    compare_cycle(late=True)
