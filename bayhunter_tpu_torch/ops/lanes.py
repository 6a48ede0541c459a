"""Launch geometry shared by the kernels that stage whole chains in
shared memory (K2 ``ops/walk.py``, K3/K3r ``ops/resp.py``): the card's
shared-memory limits and the executed-versus-useful count of lane work.

A kernel of this kind gives each block a tile of whole chains; thread
``t`` of the block serves, in round ``k``, the tile's lane
``j = k * threads + t`` (or idles past the tile's last lane).  Each
wrapper's ``lane_map`` writes that map out as the kernel computes it, so
that a CPU test can check it covers every (chain, lane) once, and
:func:`executed_work` reads what a warp executes from it.
"""

import numpy as np

WARP = 32
SMS = 132           # streaming multiprocessors of an H100 SXM
# shared memory of one block on an H100 (Hopper): 48 KB without opting
# in, 227 KB (232,448 bytes) after cudaFuncSetAttribute; the kernels opt
# in themselves for a launch above SMEM_DEFAULT
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 232448


def executed_work(lane_map, steps, layers):
    """(executed, useful) lane work of a launch.

    ``lane_map`` (blocks, rounds, threads) int: the global lane each
    thread serves in each round, -1 where it idles.  ``steps`` and
    ``layers`` (lanes,): the number of trips each lane makes through its
    layer loop (secular evaluations; 1 for the RF recursion) and the
    layers each trip runs.  A warp executes, on its t-th trip, the layers
    of its deepest lane still working, for all 32 threads; ``useful``
    counts each lane's own trips times its own layers."""
    steps = np.asarray(steps, np.int64).reshape(-1)
    layers = np.asarray(layers, np.int64).reshape(-1)
    m = np.asarray(lane_map).reshape(-1, WARP)
    live = m >= 0
    idx = np.where(live, m, 0)
    s = np.where(live, steps[idx], 0)
    ly = np.where(live, layers[idx], 0)
    executed = 0
    for trip in range(1, int(s.max(initial=0)) + 1):
        executed += WARP * int(np.where(s >= trip, ly, 0).max(axis=1).sum())
    return executed, int((steps * layers).sum())
