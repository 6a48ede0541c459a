"""Launch geometry of the kernels that stage whole chains in shared
memory (K2 ``ops/walk.py``, K3/K3r ``ops/resp.py``), checked on the CPU:
every (chain, lane) is served exactly once at ragged shapes, the shared
bytes fit the card, and a launch above 48 KB opts in to more.
"""

import os
import re

import numpy as np
import pytest

from bayhunter_tpu_torch.ops import lanes, resp, walk

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'bayhunter_tpu_torch', 'csrc')
NL = 21


def _covered_once(lane_map, n):
    served = np.sort(lane_map[lane_map >= 0])
    return np.array_equal(served, np.arange(n))


@pytest.mark.parametrize('iwave', [2, 1])
@pytest.mark.parametrize('R', [1, 21, 60])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_walker_lanes_covered_once(C, R, iwave):
    geo = walk.geometry(C, R, NL, iwave)
    assert geo.threads % lanes.WARP == 0 and geo.threads <= walk.MAX_THREADS
    assert geo.smem <= lanes.SMEM_MAX
    top = np.random.RandomState(C + R).randint(-1, NL - 1, C)
    lm = walk.lane_map(geo, C, R, top)
    assert lm.shape[0] == geo.blocks and lm.shape[2] == geo.threads
    assert _covered_once(lm, C * R)
    # every block serves whole chains, ordered by top
    for b in (0, geo.blocks - 1):
        lane = lm[b].reshape(-1)
        chains = lane[lane >= 0] // R
        assert set(chains) == set(range(b * geo.tile,
                                        min(C, (b + 1) * geo.tile)))
        assert np.all(np.diff(top[chains]) >= 0)


@pytest.mark.parametrize('q', [False, True], ids=['K3', 'K3r'])
@pytest.mark.parametrize('F', [1, 99, 257])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_response_lanes_covered_once(C, F, q):
    geo = resp.geometry(C, F, NL, q)
    assert geo.threads % lanes.WARP == 0 and geo.threads <= resp.MAX_THREADS
    assert geo.cs % 4 == 0 and geo.smem >= 4 * (geo.tile * geo.cs + 1)
    assert geo.smem <= lanes.SMEM_MAX
    lm = resp.lane_map(geo, C, F)
    assert lm.shape[0] == geo.blocks and lm.shape[2] == geo.threads
    assert _covered_once(lm, C * F)
    # every block serves its tile's whole chains
    for b in (0, geo.blocks - 1):
        lane = lm[b].reshape(-1)
        assert set(lane[lane >= 0] // F) == set(
            range(b * geo.tile, min(C, (b + 1) * geo.tile)))


def test_shared_bytes_fit_at_the_widest_shapes():
    for iwave in (1, 2):
        assert walk.geometry(10240, 60, NL, iwave).smem < 227 * 1024
    for q in (False, True):
        assert resp.geometry(10240, 257, NL, q).smem < 227 * 1024


def test_launches_above_48kb_opt_in():
    # the walker's R = 1 tile (128 chains) and 41 layer slots need more
    # than the 48 KB a launch gets without cudaFuncSetAttribute
    assert lanes.SMEM_DEFAULT == 48 * 1024
    assert walk.geometry(100, 1, NL, 2).smem > lanes.SMEM_DEFAULT
    assert walk.geometry(100, 21, 41, 2).smem > lanes.SMEM_DEFAULT
    assert walk.geometry(10240, 21, NL, 2).smem <= lanes.SMEM_DEFAULT
    assert resp.geometry(10240, 99, NL).smem <= lanes.SMEM_DEFAULT
    # each launch opts in exactly when its bytes pass 48 KB
    for name, kernels in (('walk.cu', 1), ('resp.cu', 1)):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        guarded = re.findall(r'if \(smem > 48 \* 1024\) \{\s*cudaError_t e = '
                             r'cudaFuncSetAttribute\(', src)
        assert len(guarded) == kernels
        assert src.count('cudaFuncSetAttribute') == kernels


def test_thread_limits_agree_with_the_kernels():
    for name, const, value in (('walk.cu', 'WALK_MAX_THREADS',
                                walk.MAX_THREADS),
                               ('resp.cu', 'RESP_MAX_THREADS',
                                resp.MAX_THREADS)):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        assert re.search(r'constexpr int %s = (\d+);' % const,
                         src).group(1) == str(value)
    with open(os.path.join(CSRC, 'resp.cu')) as f:
        assert 'N_SC = %d;' % resp.N_SCALARS in f.read()


def test_larger_layer_counts_shrink_the_walker_block():
    geo = walk.geometry(1000, 21, 200, 2)
    assert geo.threads < walk.MAX_THREADS and geo.smem <= lanes.SMEM_MAX
    with pytest.raises(ValueError):
        walk.geometry(1000, 21, 2000, 2)
