"""Launch geometry of the kernels that stage whole chains in shared
memory (K2 ``ops/walk.py``, K3/K3r ``ops/resp.py``, K1/K6
``ops/prep.py``, K4/K5 ``ops/swd.py``), checked on the CPU: every
(chain, lane) is served exactly once at ragged shapes, every K1/K6 and
K4/K5 output element is stored exactly once, no K4/K5 warp straddles
two chains, the shared bytes fit the card, and a launch above 48 KB
opts in to more; K1's cached launch constants equal freshly built ones.
"""

import os
import re

import numpy as np
import pytest

from bayhunter_tpu_torch.ops import _ext, lanes, prep, resp, rf, swd, walk

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


def _check_prep_stores(C, nl, n_rf, model):
    geo = prep.geometry(C, nl, n_rf, model)
    assert geo.threads % lanes.WARP == 0 and geo.threads <= prep.MAX_THREADS
    assert geo.tile in prep.TILES
    assert (geo.blocks - 1) * geo.tile < C <= geo.blocks * geo.tile
    assert geo.smem == 4 * prep.tile_floats(nl, model) * geo.tile
    assert geo.smem <= lanes.SMEM_MAX
    rows = {'coefs%d' % s: (nl - 1) * 32 for s in range(n_rf)}
    rows.update({'pack%d' % s: rf.pack_offsets(nl)['rows']
                 for s in range(n_rf)})
    if model:
        rows.update(props=4 * nl, valid=1, swd=3)
    # full tiles repeat the first block's map shifted by whole tiles: the
    # first, a middle and the last (ragged) block
    for b in sorted({0, geo.blocks // 2, geo.blocks - 1}):
        stores = prep.item_stores(geo, C, nl, n_rf, b, model)
        assert sorted(stores) == sorted(rows)
        chains = np.arange(b * geo.tile, min(C, (b + 1) * geo.tile))
        for name, idx in stores.items():
            want = (np.arange(rows[name])[:, None] * C + chains).reshape(-1)
            assert np.array_equal(np.sort(idx), np.sort(want)), name


@pytest.mark.parametrize('n_rf', [0, 1, 2, 4])
@pytest.mark.parametrize('nl', [2, 21, 64])
@pytest.mark.parametrize('C', [1, 37, 2048, 10237])
def test_model_operand_stores_once(C, nl, n_rf):
    _check_prep_stores(C, nl, n_rf, True)


@pytest.mark.parametrize('nl', [2, 21, 64])
@pytest.mark.parametrize('C', [1, 37, 2048, 10237])
def test_rf_operand_stores_once(C, nl):
    _check_prep_stores(C, nl, 1, False)


def test_prep_tiles_fill_the_card():
    # 10,240 chains: tiles of 32, at least two blocks per SM; a
    # 2,048-chain cold chunk: tiles of 16, a block for nearly every SM
    for model, n_rf in ((True, 1), (True, 2), (False, 1)):
        geo = prep.geometry(10240, NL, n_rf, model)
        assert geo.tile == 32 and geo.blocks >= 2 * lanes.SMS
        assert geo.threads == prep.MAX_THREADS
        geo = prep.geometry(2048, NL, n_rf, model)
        assert geo.tile == 16 and geo.blocks == 128


def test_prep_shared_bytes_fit_and_opt_in():
    assert prep.geometry(10240, 64, 4).smem <= lanes.SMEM_MAX
    assert prep.geometry(10240, NL, 2).smem <= lanes.SMEM_DEFAULT
    assert prep.geometry(10240, 64, 1).smem > lanes.SMEM_DEFAULT
    with pytest.raises(ValueError):
        prep.geometry(100, 1000, 1)
    with open(os.path.join(CSRC, 'prep.cu')) as f:
        src = f.read()
    # K1 and K6 each opt in exactly when their bytes pass 48 KB
    guarded = re.findall(r'if \(smem > 48 \* 1024\) \{\s*cudaError_t e = '
                         r'cudaFuncSetAttribute\(', src)
    assert len(guarded) == 2 == src.count('cudaFuncSetAttribute')
    assert re.search(r'constexpr int PREP_MAX_THREADS = (\d+);',
                     src).group(1) == str(prep.MAX_THREADS)
    for fn, model in (('prep_floats', True), ('rf_prep_floats', False)):
        body = re.search(r'int %s\(int nl\) \{ return (.*?); \}' % fn,
                         src).group(1)
        for nl in (2, 21, 64):
            assert eval(body, {'nl': nl}) == prep.tile_floats(nl, model)


def _c_fields(src, struct):
    """(name, C type, array length or None) of a struct in ``src``."""
    body = re.search(r'struct %s \{(.*?)\};' % struct, src, re.S).group(1)
    out = []
    for ctype, names in re.findall(r'(int|float) ([^;]+);', body):
        for name in names.split(','):
            m = re.match(r'\s*(\w+)(?:\[(\w+)\])?', name)
            out.append((m.group(1), ctype, m.group(2)))
    return out


def test_prep_structs_agree_with_ctypes():
    with open(os.path.join(CSRC, 'prep.cu')) as f:
        src = f.read()
    assert re.search(r'#define RF_MAX (\d+)', src).group(1) == str(
        _ext.RF_MAX)
    for struct, cls in (('RfSpecs', _ext.RfSpecs),
                        ('PriorCfg', _ext.PriorCfg)):
        want = []
        for name, ctype in cls._fields_:
            length = getattr(ctype, '_length_', None)
            base = ctype if length is None else ctype._type_
            want.append((name, {_ext.ctypes.c_int: 'int',
                                _ext.ctypes.c_float: 'float'}[base],
                         None if length is None else 'RF_MAX'))
        assert _c_fields(src, struct) == want


P_SKM = 6.4 * rf.DEG_PER_KM


@pytest.mark.parametrize('nl', [2, NL])
def test_cached_launch_constants_equal_fresh_ones(nl):
    # specs change between calls: P, then SV, then one set, then two,
    # then P again: each cached entry equals a freshly built one
    p, s = (P_SKM, rf.P_WAVE), (5.5 * rf.DEG_PER_KM, rf.SV_WAVE)
    first = prep.cached_outputs(nl, (p,))
    for specs in ((p,), (s,), (p, s), (s, p, p, s), (), (p,)):
        got = prep.cached_outputs(nl, specs)
        fresh = prep.outputs(nl, specs)
        assert bytes(got.specs) == bytes(fresh.specs)
        assert bytes(got.layout) == bytes(fresh.layout)
        assert got[2:] == fresh[2:]
        assert got.specs.n == len(specs)
        for k, (pk, wave) in enumerate(specs):
            assert got.specs.p[k] == np.float32(pk)
            assert got.specs.wave[k] == wave
        # the planes tile the buffer's rows in order: props, [cm; bx;
        # top], then each target's table and pack at the rows the struct
        # names
        starts = np.cumsum((0,) + got.sizes)
        assert starts[-1] == got.rows
        assert got.sizes[:2] == (4 * nl, 3)
        assert got.sizes[2::2] == ((nl - 1) * 32,) * len(specs)
        assert got.sizes[3::2] == (rf.pack_offsets(nl)['rows'],) * len(
            specs)
        assert list(starts[2:-1:2]) == list(got.specs.coefs)[:len(specs)]
        assert list(starts[3::2]) == list(got.specs.pack)[:len(specs)]
    assert prep.cached_outputs(nl, (p,)) is first
    assert bytes(first.specs) == bytes(prep.outputs(nl, (p,)).specs)


# K4/K5's grids: the cold search's sign-0 (K = 1), refine (17) and
# counting-block (64) shapes at 21 periods, and a wide one
SECULAR_SHAPES = [(21, 1), (21, 17), (21, 64), (60, 64)]


@pytest.mark.parametrize('nl', [2, 21, 64])
@pytest.mark.parametrize('R,K', SECULAR_SHAPES)
@pytest.mark.parametrize('C', [1, 7, 2051])
def test_secular_stores_once_in_whole_chain_warps(C, R, K, nl):
    E = R * K
    for iwave in (2, 1):
        geo = swd.geometry(C, R, K, nl, iwave)
        assert geo.threads % lanes.WARP == 0
        assert geo.threads <= swd.MAX_THREADS
        assert (geo.blocks - 1) * geo.tile < C <= geo.blocks * geo.tile
        assert geo.smem == 4 * geo.tile * (swd.chain_floats(nl, R, iwave)
                                           + 1)
        assert geo.smem <= lanes.SMEM_MAX
        m = swd.store_map(geo, C, R, K)
        assert m.shape[0] == geo.blocks and m.shape[2] == geo.threads
        assert np.array_equal(np.bincount(m[m >= 0], minlength=C * E),
                              np.ones(C * E, np.int64))
        # every warp's stores lie in one chain, of its block's tile
        w = m.reshape(geo.blocks, -1, lanes.WARP)
        chain = np.where(w >= 0, w // E, -1)
        first = np.where(w >= 0, chain, C).min(axis=2)
        last = chain.max(axis=2)
        busy = last >= 0
        assert np.array_equal(first[busy], last[busy])
        block = np.broadcast_to(np.arange(geo.blocks)[:, None], busy.shape)
        assert np.array_equal(last[busy] // geo.tile, block[busy])


def test_secular_tiles_fill_the_block_at_the_cold_search_shapes():
    # a 2,048-chain cold chunk and 10,240 chains at 21 periods: the
    # tile's warp-slots are whole rounds of 8 warps
    for C in (2048, 10240):
        for K in (1, 17, 64):
            for iwave in (2, 1):
                geo = swd.geometry(C, 21, K, NL, iwave)
                W = -(-21 * K // lanes.WARP)
                assert geo.threads == swd.MAX_THREADS
                assert geo.tile * W % (geo.threads // lanes.WARP) == 0
                assert geo.smem <= lanes.SMEM_DEFAULT


def test_secular_shared_bytes_agree_with_the_kernel_and_opt_in():
    with open(os.path.join(CSRC, 'secular.cu')) as f:
        src = f.read()
    assert re.search(r'constexpr int SECULAR_MAX_THREADS = (\d+);',
                     src).group(1) == str(swd.MAX_THREADS)
    for fn, iwave in (('rayleigh_floats', 2), ('love_floats', 1)):
        body = re.search(r'int %s\(int nl, int R\) \{ return (.*?); \}'
                         % fn, src).group(1)
        for nl in (2, 21, 64):
            for R in (1, 21, 60):
                assert eval(body, {'nl': nl, 'R': R}) == swd.chain_floats(
                    nl, R, iwave)
    # the entry points refuse less than the tile's floats and tops
    assert 'smem < 4 * (long)tile * (floats + 1)' in src
    # one guarded opt-in serves K4's and K5's launches
    guarded = re.findall(r'if \(smem > 48 \* 1024\) \{\s*cudaError_t e = '
                         r'cudaFuncSetAttribute\(', src)
    assert len(guarded) == 1 == src.count('cudaFuncSetAttribute')
    # four chains of 60 periods at 64 slots need more than 48 KB
    assert swd.geometry(2051, 60, 1, 64, 2).smem > lanes.SMEM_DEFAULT
    assert swd.geometry(2051, 60, 1, 64, 2).smem <= lanes.SMEM_MAX
    with pytest.raises(ValueError):
        swd.geometry(10, 200, 64, 200, 2)
