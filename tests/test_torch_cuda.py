"""CUDA kernels vs their plain twins on the card: K1-K3 at a small
batch, K4/K5 (secular values), K6 (RF operands), K3 over all 257
frequencies, K2's Love branch, K3 for SV incidence, K3r (per-layer Q,
P and SV) and K1 with a P and an S receiver-function target bit for
bit; and the redesigned K2, K3 and K3r bit for bit at ragged shapes
(C = 1, 37, 10,237 chains; R = 1, 21, 60 periods; F = 1, 99, 257
frequency lanes), on models whose deepest layer runs from a pure
halfspace to slot NL - 2, with a water-surface chain for K2 and both
wave types (K2 at R = 1 stages 128 chains a block, above the 48 KB of
shared memory a launch gets without opting in); the redesigned K1 and
K6 bit for bit at ragged shapes (C = 1, 37, 10,237 chains; K1 with 0,
1, 2 and 4 RF targets of both wave types, with and without the
low/high-velocity-zone limits; K6 for P and SV) and at 80 layer slots
(above 48 KB of shared memory), each into device memory filled with NaN
before the launch, so that an element the kernel never stores shows;
K4 and K5 bit for bit at ragged shapes (C = 1, 7, 2,051 chains; 21
and 60 periods of 1, 17 or 64 candidates; 2, 21 and 64 layer slots,
with a pure halfspace and a water top) and at the cold search's three
grids as its drivers broadcast them, on single-layer and ragged models,
into NaN-filled memory; and that K1's, K2's, K3's, K3r's, K4's, K5's
and K6's entry points refuse a launch geometry with too little shared
memory.

Needs an NVIDIA GPU and nvcc (marker ``cuda``); skipped elsewhere.  On
a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the same checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk

NL = 21
PRIORS = prep.ModelPriors(1, 20, 2.0, 5.0, 0.0, 60.0, 0.1, None, None)
P_SKM = 6.4 * rf.DEG_PER_KM
RF_P = ((P_SKM, rf.P_WAVE),)      # K1's RF spec of the main path

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    return torch.device('cuda', 0)


def _models(dev, C=300, seed=7):
    rs = np.random.RandomState(seed)
    n = rs.randint(2, 10, C).astype(np.int32)
    vs = np.sort(rs.uniform(2.05, 4.95, (C, NL)), axis=1)
    z = np.sort(rs.uniform(0.0, 58.0, (C, NL)), axis=1)
    z[::5, 3] = z[::5, 2] + 0.01
    for i in range(C):
        z[i, n[i]:] = 120.0 + np.arange(NL - n[i])
    return (torch.tensor(vs.T.copy(), dtype=torch.float32, device=dev),
            torch.tensor(z.T.copy(), dtype=torch.float32, device=dev),
            torch.tensor(n, device=dev),
            torch.full((C,), 1.73, dtype=torch.float32, device=dev))


def test_model_operands_kernel_matches_twin(dev):
    args = _models(dev) + (PRIORS, RF_P)
    before = prep.model_operands.launches
    kv, ksw, krf = prep.model_operands(*args)
    pv, psw, prf = prep.model_operands_plain(*args)
    assert prep.model_operands.launches == before + 1
    assert torch.equal(kv, pv)
    assert 0 < int(kv.sum()) < kv.numel()
    for a, b in zip(ksw + krf, psw + prf):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-6)


@pytest.mark.parametrize('setting', ['vs', 'z', 'dim'])
def test_walker_kernel_matches_twin(dev, setting):
    st = {'vs': swd.WARM_VS, 'z': swd.WARM_Z, 'dim': swd.WARM_DIM}[setting]
    _, (props, cm, bx, top), _ = prep.model_operands(*_models(dev),
                                                     PRIORS, RF_P)
    periods = np.linspace(1, 41, 21).astype(np.float32)
    h, vp, vs, rho = (props[k * NL:(k + 1) * NL].T.contiguous()
                      for k in range(4))
    _, _, roots, slopes = swd.surfdisp_roots_cold(h, vp, vs, rho, periods)
    c_prev = roots + 0.0013
    kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
              nbisect=st['nbisect'], newton_iters=st['newton_iters'],
              newton_maxshift=swd.NEWTON_MAXSHIFT,
              slope_prev=slopes if st['cached_slope'] else None)
    args = (props, swd.angular_frequencies(periods, dev), c_prev, cm, bx,
            top)
    kc, kf, ks = walk.warm_roots_walk(*args, **kw)
    pc, pf, ps = walk.warm_roots_walk_plain(*args, **kw)
    assert float((kf != pf).float().mean()) <= 1e-4
    both = kf & pf
    d = (kc - pc).abs()[both]
    assert float(torch.quantile(d, 0.9)) < 2e-5
    assert float(d.max()) < 5e-4


def test_response_kernel_matches_twin(dev):
    _, _, ((coefs, pack),) = prep.model_operands(*_models(dev), PRIORS,
                                                 RF_P)
    cut = rf.gauss_cut(512, 5.0, 1.0)
    ko = resp.resp(coefs, pack, cut, 512, 5.0)
    po = resp.resp_plain(coefs, pack, cut, 512, 5.0)
    scale = float(torch.maximum(po[0].abs().max(), po[1].abs().max()))
    for a, b in zip(ko, po):
        assert float((a - b).abs().max()) <= 1e-5 * scale


def _layers(dev, C):
    """(C, NL) layer arrays h, vp, vs, rho of :func:`_models` from K1's
    walker planes."""
    _, (props, _, _, _), _ = prep.model_operands(*_models(dev, C=C),
                                                 PRIORS, RF_P)
    return tuple(props[k * NL:(k + 1) * NL].T.contiguous() for k in range(4))


@pytest.mark.parametrize('iwave', [2, 1], ids=['K4', 'K5'])
def test_secular_kernels_match_twins_bitwise(dev, iwave):
    C, R, K = 10240, 21, 64
    h, vp, vs, rho = _layers(dev, C)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    c = 2.0 + 2.8 * torch.rand((C, R, K), generator=gen, device=dev)
    omega = swd.angular_frequencies(np.linspace(1, 41, R), dev)[None, :,
                                                                None]
    counter = swd.secular1 if iwave == 1 else swd.secular4
    before = counter.launches
    k = swd.secular_at(c, omega, h, vp, vs, rho, iwave)
    assert counter.launches == before + 1
    if iwave == 1:
        p = swd.dltar1(omega / c, omega, h, vs, rho)
    else:
        p = swd.dltar4(omega / c, omega, h, vp, vs, rho)
    assert k.shape == (C, R, K)
    assert bool(torch.isfinite(k).all())
    assert torch.equal(k, p)


def test_rf_operands_kernel_matches_twin_bitwise(dev):
    layers = tuple(x.T.contiguous() for x in _layers(dev, 10240))
    before = prep.rf_operands.launches
    kc, kp = prep.rf_operands(*layers, P_SKM)
    assert prep.rf_operands.launches == before + 1
    pc, pp = prep.rf_operands_plain(*layers, P_SKM)
    assert torch.equal(kc, pc)
    assert torch.equal(kp, pp)


def test_response_kernel_all_frequencies_matches_twin(dev):
    layers = tuple(x.T.contiguous() for x in _layers(dev, 1024))
    coefs, pack = prep.rf_operands(*layers, P_SKM)
    ko = resp.resp(coefs, pack, 257, 512, 5.0)
    po = resp.resp_plain(coefs, pack, 257, 512, 5.0)
    assert ko[0].shape == (1024, 257)
    for a, b in zip(ko, po):
        assert torch.equal(a, b)


@pytest.mark.parametrize('setting', ['vs', 'z', 'dim'])
def test_love_walker_kernel_matches_twin_bitwise(dev, setting):
    st = {'vs': swd.WARM_VS, 'z': swd.WARM_Z, 'dim': swd.WARM_DIM}[setting]
    _, (props, cm, bx, top), _ = prep.model_operands(*_models(dev),
                                                     PRIORS, RF_P)
    periods = np.linspace(1, 41, 21).astype(np.float32)
    h, vp, vs, rho = (props[k * NL:(k + 1) * NL].T.contiguous()
                      for k in range(4))
    _, _, roots, slopes = swd.surfdisp_roots_cold(h, vp, vs, rho, periods, 1)
    c_prev = roots + 0.0013
    kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
              nbisect=st['nbisect'], newton_iters=st['newton_iters'],
              newton_maxshift=swd.NEWTON_MAXSHIFT,
              slope_prev=slopes if st['cached_slope'] else None, iwave=1)
    args = (props, swd.angular_frequencies(periods, dev), c_prev, cm, bx,
            top)
    kc, kf, ks = walk.warm_roots_walk(*args, **kw)
    pc, pf, ps = walk.warm_roots_walk_plain(*args, **kw)
    # these random models include halfspaces within a few m/s of the
    # layer above, whose long-period Love roots the cold search cannot
    # bracket: count the walks that start from a found root
    cold = slopes != 0.0
    assert float(cold.float().mean()) > 0.8
    assert float(kf[cold].float().mean()) > 0.9
    assert torch.equal(kf, pf)
    assert torch.equal(kc, pc)
    assert torch.equal(ks, ps)


def _q_planes(dev, C, seed=5):
    """(NL, C) Qp, Qs planes: Qs in 50-600 increasing with depth, Qp =
    2.25 Qs."""
    rs = np.random.RandomState(seed)
    qs = np.sort(rs.uniform(50.0, 600.0, (C, NL)), axis=1).T.copy()
    return (torch.tensor(2.25 * qs, dtype=torch.float32, device=dev),
            torch.tensor(qs, dtype=torch.float32, device=dev))


@pytest.mark.parametrize('wave', [rf.P_WAVE, rf.SV_WAVE], ids=['P', 'SV'])
def test_array_q_response_kernel_matches_twin_bitwise(dev, wave):
    layers = tuple(x.T.contiguous() for x in _layers(dev, 2048))
    coefs, pack = prep.rf_operands(*layers, P_SKM, wave)
    qp, qs = _q_planes(dev, 2048)
    cut = rf.gauss_cut(512, 5.0, 1.0)
    before = resp.resp_q.launches, resp.resp_q.sv_launches
    ko = resp.resp_q(coefs, pack, qp, qs, cut, 512, 5.0, wave)
    assert (resp.resp_q.launches, resp.resp_q.sv_launches) == (
        before[0] + 1, before[1] + wave)
    po = resp.resp_q_plain(coefs, pack, qp, qs, cut, 512, 5.0, wave)
    assert ko[0].shape == (2048, cut)
    for a, b in zip(ko, po):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def test_sv_response_kernel_matches_twin_bitwise(dev):
    layers = tuple(x.T.contiguous() for x in _layers(dev, 2048))
    kc, kp = prep.rf_operands(*layers, P_SKM, rf.SV_WAVE)
    pc, pp = prep.rf_operands_plain(*layers, P_SKM, rf.SV_WAVE)
    assert torch.equal(kc, pc) and torch.equal(kp, pp)
    for cut in (rf.gauss_cut(512, 5.0, 1.0), 257):
        before = resp.resp.sv_launches
        ko = resp.resp(kc, kp, cut, 512, 5.0, rf.SV_WAVE)
        assert resp.resp.sv_launches == before + 1
        po = resp.resp_plain(kc, kp, cut, 512, 5.0, rf.SV_WAVE)
        for a, b in zip(ko, po):
            assert torch.equal(a, b)


def test_model_operands_two_rf_targets_bitwise(dev):
    specs = ((P_SKM, rf.P_WAVE), (5.5 * rf.DEG_PER_KM, rf.SV_WAVE))
    args = _models(dev, C=2048) + (PRIORS, specs)
    kv, ksw, krf = prep.model_operands(*args)
    pv, psw, prf = prep.model_operands_plain(*args)
    assert torch.equal(kv, pv)
    assert len(krf) == len(prf) == 2
    for a, b in zip(ksw + krf[0] + krf[1], psw + prf[0] + prf[1]):
        assert torch.equal(a, b)
    t0 = rf.pack_offsets(NL)['t0']
    assert not torch.equal(krf[0][1][t0], krf[1][1][t0])


def _ragged_planes(dev, C, water=True, seed=13, nl=NL):
    """(nl, C) planes h, vp, vs, rho and (C,) float top of random models
    whose deepest layer ``top`` runs over -1..nl-2 (the first chains
    take -1 and nl - 2); slots below top are halfspace copies of zero
    thickness, and with ``water`` chain C // 2 has a water layer on
    top."""
    rs = np.random.RandomState(seed)
    top = rs.randint(-1, nl - 1, C)
    top[:2] = [-1, nl - 2][:C]
    vs = np.sort(rs.uniform(2.0, 4.8, (C, nl)), axis=1)
    h = rs.uniform(0.5, 8.0, (C, nl))
    for i in range(C):
        h[i, top[i] + 1:] = 0.0
        vs[i, top[i] + 1:] = vs[i, -1]
    vp = 1.73 * vs
    rho = 0.32 * vp + 0.77
    if water and C > 2:
        w = C // 2
        top[w] = max(top[w], min(2, nl - 2))
        h[w, :top[w] + 1] = np.maximum(h[w, :top[w] + 1], 0.5)
        vs[w, 0], vp[w, 0], rho[w, 0] = 0.0, 1.5, 1.03
    planes = tuple(torch.tensor(x.T.copy(), dtype=torch.float32, device=dev)
                   for x in (h, vp, vs, rho))
    return planes, torch.tensor(top, dtype=torch.float32, device=dev)


@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
@pytest.mark.parametrize('R', [1, 21, 60])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_walker_ragged_shapes_bitwise(dev, C, R, iwave):
    planes, top = _ragged_planes(dev, C)
    props = torch.cat(planes).contiguous()
    cm, bx = swd.lower_bound(planes[1], planes[2], dim=0)
    periods = np.linspace(1.0, 60.0, R).astype(np.float32)
    _, _, roots, slopes = swd.surfdisp_roots_cold(
        *(x.T.contiguous() for x in planes), periods, iwave)
    mid = 0.5 * (cm + bx)[:, None].expand_as(roots)
    c_prev = torch.where(slopes != 0.0, roots + 0.0013, mid).contiguous()
    args = (props, swd.angular_frequencies(periods, dev), c_prev, cm, bx,
            top)
    for st in (swd.WARM_VS, swd.WARM_Z, swd.WARM_DIM):
        kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
                  nbisect=st['nbisect'], newton_iters=st['newton_iters'],
                  newton_maxshift=swd.NEWTON_MAXSHIFT, iwave=iwave,
                  slope_prev=slopes if st['cached_slope'] else None)
        before = walk.warm_roots_walk.launches
        kc, kf, ks = walk.warm_roots_walk(*args, **kw)
        assert walk.warm_roots_walk.launches == before + 1
        pc, pf, ps = walk.warm_roots_walk_plain(*args, **kw)
        assert torch.equal(kf, pf)
        assert torch.equal(kc, pc)
        assert torch.equal(ks, ps)


def _ragged_q(dev, C, seed=17):
    """(NL, C) Qp, Qs planes: uniform Q for every third chain, Q
    contrasts only above a random slot for the next, at every slot for
    the rest."""
    rs = np.random.RandomState(seed)
    qs = np.sort(rs.uniform(50.0, 600.0, (C, NL)), axis=1)
    for i in range(0, C, 3):
        qs[i] = qs[i, 0]
    for i in range(1, C, 3):
        k = rs.randint(0, NL)
        qs[i, k:] = qs[i, k]
    qs = qs.T.copy()
    return (torch.tensor(2.25 * qs, dtype=torch.float32, device=dev),
            torch.tensor(qs, dtype=torch.float32, device=dev))


@pytest.mark.parametrize('q', [False, True], ids=['K3', 'K3r'])
@pytest.mark.parametrize('F', [1, 99, 257])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_response_ragged_shapes_bitwise(dev, C, F, q):
    planes, _ = _ragged_planes(dev, C, water=False)
    qp, qs = _ragged_q(dev, C)
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        coefs, pack = prep.rf_operands(*planes, P_SKM, wave)
        depth = pack[rf.pack_offsets(NL)['depth']]
        if C > 1:
            assert float(depth.min()) == 0.0
            assert float(depth.max()) == NL - 2
        if q:
            ko = resp.resp_q(coefs, pack, qp, qs, F, 512, 5.0, wave)
            po = resp.resp_q_plain(coefs, pack, qp, qs, F, 512, 5.0, wave)
        else:
            ko = resp.resp(coefs, pack, F, 512, 5.0, wave)
            po = resp.resp_plain(coefs, pack, F, 512, 5.0, wave)
        for a, b in zip(ko, po):
            assert a.shape == (C, F)
            assert bool(torch.isfinite(a).all())
            assert torch.equal(a, b)


@pytest.mark.parametrize('kernel', ['K2', 'K3', 'K3r'])
def test_undersized_shared_memory_is_refused(dev, monkeypatch, kernel):
    # a geometry one float short of the kernel's shared-memory layout
    # (K2's is the wrapper's size; K3/K3r's chain records plus the
    # staged-row count, which the wrapper rounds up to 16 bytes): the
    # entry point refuses it (cudaErrorInvalidConfiguration, 9) before
    # launching
    C = 37
    planes, top = _ragged_planes(dev, C)
    mod = walk if kernel == 'K2' else resp
    real = mod.geometry

    def short(*a):
        geo = real(*a)
        return geo._replace(smem=geo.smem - 4 if kernel == 'K2'
                            else 4 * geo.tile * geo.cs)

    monkeypatch.setattr(mod, 'geometry', short)
    if kernel == 'K2':
        cm, bx = swd.lower_bound(planes[1], planes[2], dim=0)
        omegas = swd.angular_frequencies(np.linspace(1.0, 60.0, 21), dev)
        c_prev = (0.5 * (cm + bx))[:, None].expand(C, 21).contiguous()
        fn = counter = walk.warm_roots_walk
        args = (torch.cat(planes).contiguous(), omegas, c_prev, cm, bx, top,
                1, 1, 0, 0, swd.NEWTON_MAXSHIFT)
    else:
        coefs, pack = prep.rf_operands(*planes, P_SKM)
        fn = counter = resp.resp if kernel == 'K3' else resp.resp_q
        args = ((coefs, pack, 99, 512, 5.0) if kernel == 'K3' else
                (coefs, pack) + _ragged_q(dev, C) + (99, 512, 5.0))
    before = counter.launches
    with pytest.raises(RuntimeError, match='CUDA error 9 '):
        fn(*args)
    assert counter.launches == before



def _poison(dev):
    """Fills freed device memory with NaN: the caching allocator hands
    it to the next outputs, so that an element a kernel never stores
    stays NaN and fails the comparison with its twin."""
    torch.full((1 << 24,), float('nan'), device=dev)


def _nuclei(dev, C, nl=NL, seed=19):
    """(NL, C) nucleus planes vs, z and (C,) n, vpvs of random models
    with 1..nl nuclei (the first chains 1 and nl), padded as the sampler
    pads them."""
    rs = np.random.RandomState(seed)
    n = rs.randint(1, nl + 1, C).astype(np.int32)
    n[:2] = [1, nl][:C]
    vs = np.sort(rs.uniform(2.05, 4.95, (C, nl)), axis=1)
    z = np.sort(rs.uniform(0.0, 58.0, (C, nl)), axis=1)
    for i in range(C):
        vs[i, n[i]:] = vs[i, n[i] - 1]
        z[i, n[i]:] = 120.0 + np.arange(nl - n[i])
    return (torch.tensor(vs.T.copy(), dtype=torch.float32, device=dev),
            torch.tensor(z.T.copy(), dtype=torch.float32, device=dev),
            torch.tensor(n, device=dev),
            torch.tensor(rs.uniform(1.6, 1.9, C), dtype=torch.float32,
                         device=dev))


RF_SPECS4 = ((P_SKM, rf.P_WAVE), (5.5 * rf.DEG_PER_KM, rf.SV_WAVE),
             (7.0 * rf.DEG_PER_KM, rf.P_WAVE), (P_SKM, rf.SV_WAVE))
PRIORS_ZONES = PRIORS._replace(lvz=0.2, hvz=0.3)


def _model_operands_bitwise(dev, nuclei, specs):
    for priors in (PRIORS, PRIORS_ZONES):
        args = nuclei + (priors, specs)
        _poison(dev)
        before = prep.model_operands.launches
        kv, ksw, krf = prep.model_operands(*args)
        assert prep.model_operands.launches == before + 1
        pv, psw, prf = prep.model_operands_plain(*args)
        assert torch.equal(kv, pv)
        assert len(krf) == len(prf) == len(specs)
        for a, b in zip(ksw + sum(krf, ()), psw + sum(prf, ())):
            assert a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize('n_rf', [0, 1, 2, 4])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_model_operands_ragged_shapes_bitwise(dev, C, n_rf):
    _model_operands_bitwise(dev, _nuclei(dev, C), RF_SPECS4[:n_rf])


@pytest.mark.parametrize('C', [1, 37, 10237])
def test_rf_operands_ragged_shapes_bitwise(dev, C):
    planes, _ = _ragged_planes(dev, C, water=False)
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        _poison(dev)
        before = prep.rf_operands.launches
        kc, kp = prep.rf_operands(*planes, P_SKM, wave)
        assert prep.rf_operands.launches == before + 1
        pc, pp = prep.rf_operands_plain(*planes, P_SKM, wave)
        assert torch.equal(kc, pc) and torch.equal(kp, pp)


def test_prep_wide_layers_bitwise(dev):
    # 80 layer slots: K1 and K6 stage more than the 48 KB a launch gets
    # without opting in
    nl, C = 80, 10240
    assert prep.geometry(C, nl, 2).smem > 48 * 1024
    assert prep.geometry(C, nl, 1, False).smem > 48 * 1024
    nuclei = _nuclei(dev, C, nl)
    _model_operands_bitwise(dev, nuclei, RF_SPECS4[:2])
    h, vp, vs, rho = prep.model_operands_plain(
        *nuclei, PRIORS, ())[1][0].reshape(4, nl, C)
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        _poison(dev)
        k = prep.rf_operands(h, vp, vs, rho, P_SKM, wave)
        p = prep.rf_operands_plain(h, vp, vs, rho, P_SKM, wave)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize('kernel', ['K1', 'K6'])
def test_prep_undersized_shared_memory_is_refused(dev, monkeypatch, kernel):
    # a geometry one float short of the tile's shared-memory layout: the
    # entry point refuses it (cudaErrorInvalidConfiguration, 9) before
    # launching
    C = 37
    real = prep.geometry

    def short(*a):
        geo = real(*a)
        return geo._replace(smem=geo.smem - 4)

    monkeypatch.setattr(prep, 'geometry', short)
    if kernel == 'K1':
        fn = prep.model_operands
        args = _nuclei(dev, C) + (PRIORS, RF_P)
    else:
        fn = prep.rf_operands
        args = _ragged_planes(dev, C, water=False)[0] + (P_SKM,)
    before = fn.launches
    with pytest.raises(RuntimeError, match='CUDA error 9 '):
        fn(*args)
    assert fn.launches == before


# K4/K5's grids: the cold search's sign-0 (K = 1), refine (17) and
# counting-block (64) shapes at 21 periods, and a wide one
SECULAR_SHAPES = ((21, 1), (21, 17), (21, 64), (60, 64))


def _secular_bitwise(dev, layers, c, omega, iwave):
    """K4 (``iwave`` 2) or K5 (1) at the candidates (c, omega) into
    NaN-filled memory, bit for bit against its twin at omega / c."""
    counter = swd.secular1 if iwave == 1 else swd.secular4
    _poison(dev)
    before = counter.launches
    k = swd.secular_at(c, omega, *layers, iwave)
    assert counter.launches == before + 1
    p = swd.secular_values(omega / c, omega, *layers, iwave)
    assert k.shape == p.shape
    assert bool(torch.isfinite(p).all())
    assert torch.equal(k, p)


@pytest.mark.parametrize('nl', [2, 21, 64])
@pytest.mark.parametrize('R,K', SECULAR_SHAPES)
@pytest.mark.parametrize('C', [1, 7, 2051])
def test_secular_ragged_shapes_bitwise(dev, C, R, K, nl):
    # models from a pure halfspace to slot nl - 2, a water layer on
    # chain C // 2; random velocities (C, R, K) at R periods (R,)
    planes, _ = _ragged_planes(dev, C, nl=nl)
    layers = tuple(x.T.contiguous() for x in planes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(C + R + K + nl)
    c = 2.0 + 2.8 * torch.rand((C, R, K), generator=gen, device=dev)
    omega = swd.angular_frequencies(np.linspace(1.0, 60.0, R), dev)
    for iwave in (2, 1):
        _secular_bitwise(dev, layers, c, omega[None, :, None], iwave)


def _cold_models(dev, C, seed=29):
    """(C, NL) layer arrays of C single-layer models (one layer over
    the halfspace, as cold init draws them) and of the ragged models of
    :func:`_ragged_planes` (a pure halfspace, a water top, 5-8 layer
    chains among them)."""
    rs = np.random.RandomState(seed)
    h = np.zeros((C, NL), np.float32)
    h[:, 0] = rs.uniform(1.0, 60.0, C)
    vs = np.empty((C, NL), np.float32)
    vs[:, 0] = rs.uniform(2.0, 4.0, C)
    vs[:, 1:] = vs[:, :1] + rs.uniform(0.1, 1.0, (C, 1))
    vp = np.float32(1.73) * vs
    rho = np.float32(0.32) * vp + np.float32(0.77)
    single = tuple(torch.tensor(x, device=dev) for x in (h, vp, vs, rho))
    ragged = tuple(x.T.contiguous() for x in _ragged_planes(dev, C)[0])
    return single, ragged


@pytest.mark.parametrize('iwave', [2, 1], ids=['K4', 'K5'])
def test_secular_cold_search_grids_bitwise(dev, iwave):
    # the three grids of the cold search on a 2,048-chain chunk, each
    # broadcast as the drivers pass it: sign 0 at cm, (C, 1) against
    # (C, R) frequencies; a counting block of 64 velocities above cm,
    # (C, 1, 64); a refinement of 17 points per period, (C, R, 17)
    C, R = 2048, 21
    omega = swd.angular_frequencies(np.linspace(1, 41, R), dev).expand(C,
                                                                       R)
    fracs = torch.arange(0, 17, dtype=torch.float32, device=dev) / 16
    for layers in _cold_models(dev, C):
        cm, _ = swd.lower_bound(layers[1], layers[2], dim=-1)
        cm = cm[:, None]
        block = cm[..., None] + torch.arange(
            1, swd.KBLOCK + 1, device=dev) * swd.DDC
        lo = cm + swd.DDC * torch.arange(R, device=dev)
        pts = lo[..., None] + swd.DDC * fracs
        for c, om in ((cm, omega), (block, omega[..., None]),
                      (pts, omega[..., None])):
            _secular_bitwise(dev, layers, c, om, iwave)


@pytest.mark.parametrize('kernel', ['K4', 'K5'])
def test_secular_undersized_shared_memory_is_refused(dev, monkeypatch,
                                                     kernel):
    # a geometry one float short of the tile's layout: the entry point
    # refuses it (cudaErrorInvalidConfiguration, 9) before launching
    real = swd.geometry

    def short(*a):
        geo = real(*a)
        return geo._replace(smem=geo.smem - 4)

    monkeypatch.setattr(swd, 'geometry', short)
    layers = tuple(x.T.contiguous() for x in _ragged_planes(dev, 37)[0])
    c = torch.full((37, 21, 17), 3.0, device=dev)
    omega = swd.angular_frequencies(np.linspace(1.0, 60.0, 21), dev)
    counter = swd.secular4 if kernel == 'K4' else swd.secular1
    before = counter.launches
    with pytest.raises(RuntimeError, match='CUDA error 9 '):
        swd.secular_at(c, omega[None, :, None], *layers,
                       2 if kernel == 'K4' else 1)
    assert counter.launches == before
