"""CUDA kernels vs their plain twins on the card: K1-K3 at a small
batch, K4/K5 (secular values), K6 (RF operands), K3 over all 257
frequencies, K2's Love branch, K3 for SV incidence, K3r (per-layer Q,
P and SV) and K1 with a P and an S receiver-function target bit for
bit; and the redesigned K2, K3 and K3r bit for bit at ragged shapes
(C = 1, 37, 10,237 chains, and for K2 also 100,000 and 100,003, the
tomography's width and a ragged one above it; R = 1, 21, 60 periods;
F = 1, 99, 257 frequency lanes), on models whose deepest layer runs
from a pure halfspace to slot NL - 2, with a water-surface chain for K2
and both wave types (K2 at R = 1 stages 128 chains a block, above the
48 KB of shared memory a launch gets without opting in); the redesigned
K1 and K6 bit for bit at ragged shapes (C = 1, 37, 10,237 chains, K1
also 100,000 and 100,003; K1 with 0, 1, 2 and 4 RF targets of both
wave types, with and without the
low/high-velocity-zone limits; K6 for P and SV) and at 80 layer slots
(above 48 KB of shared memory), each into device memory filled with NaN
before the launch, so that an element the kernel never stores shows;
K4 and K5 bit for bit at ragged shapes (C = 1, 7, 2,051 chains; 21
and 60 periods of 1, 17 or 64 candidates; 2, 21 and 64 layer slots,
with a pure halfspace and a water top) and at the cold search's three
grids as its drivers broadcast them, on single-layer and ragged models,
into NaN-filled memory; K1's mantle arm bit for bit (C = 1, 37,
10,237; the mantle threshold inside, above and below the chains'
slots) into NaN-filled memory; that K1's, K2's, K3's, K3r's, K4's, K5's
and K6's entry points refuse a launch geometry with too little shared
memory; a 64-chain ``MCMC_Optimizer`` run on the card that writes
the ``.npy`` contract; and the dispersion arms bit for bit into
NaN-filled memory (C = 1, 37, 10,237): K1's spherical kernel with the
flat set, the spherical set and the Love density plane in five
combinations, with 0, 1 and 2 RF targets, the velocity-zone limits
and the mantle prior; K2's group arm at 42, 120 and 130 lanes in every
move class; K2 on the spherical set (Love on its density plane), phase
and group lanes; the public forward (``surfdisp``, ``SurfDisp``,
``SynRF``) without a device argument against the tutorial goldens; and
the receiver-function forms bit for bit into NaN-filled memory (C = 1,
37, 10,237): K6's unflattened arm (P and SV), K3's and K3r's options
arms 1-3 (P and SV, F = 1, 99, 257), and K1's layer planes for a custom
target without, with flat and with spherical dispersion targets; the
float64 instances of K4, K5, K6 and K3 (the per-chain ring path of
float64 runs) bit for bit against their twins run in float64, into
NaN-filled memory (C = 1, 37, 10,237; K4/K5 on the ring's and the
refinement's grids, K3 at F = 1, 99, 257 in arms 0 and 3, P and SV),
mismatched dtypes refused, and a float64 ``MCMC_Optimizer`` on the card
that runs them and no float32 kernel.

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
@pytest.mark.parametrize('C', [1, 37, 10237, 100000, 100003])
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


def _model_operands_bitwise(dev, nuclei, specs,
                            priors_set=(PRIORS, PRIORS_ZONES)):
    for priors in priors_set:
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
@pytest.mark.parametrize('C', [1, 37, 10237, 100000, 100003])
def test_model_operands_ragged_shapes_bitwise(dev, C, n_rf):
    _model_operands_bitwise(dev, _nuclei(dev, C), RF_SPECS4[:n_rf])


# the mantle threshold inside the chains' slots (vs 2.05-4.95), above
# all of them (every slot in the mantle) and below all of them (none)
MANTLES = {'inside': (4.1, 1.8), 'above': (2.0, 1.8), 'below': (5.5, 1.8)}


@pytest.mark.parametrize('where', sorted(MANTLES))
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_model_operands_mantle_bitwise(dev, C, where):
    # K1's mantle arm (prep_kernel<true>) into NaN-filled memory, with
    # and without the velocity-zone limits, one and two RF targets
    nuclei = _nuclei(dev, C)
    mantle = MANTLES[where]
    priors = (PRIORS._replace(mantle=mantle),
              PRIORS_ZONES._replace(mantle=mantle))
    for specs in (RF_P, RF_SPECS4[:2]):
        _model_operands_bitwise(dev, nuclei, specs, priors)
    vp = prep.model_operands_plain(*nuclei, priors[0], ())[1][0][NL:2 * NL]
    vp0 = prep.model_operands_plain(*nuclei, PRIORS, ())[1][0][NL:2 * NL]
    vs = prep.model_operands_plain(*nuclei, PRIORS, ())[1][0][2 * NL:3 * NL]
    if where == 'below':
        assert torch.equal(vp, vp0)
    elif where == 'above':
        assert torch.equal(vp, vs * mantle[1])
    elif C > 1:
        assert not torch.equal(vp, vp0)


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


def test_optimizer_writes_the_contract_on_the_card(dev, tmp_path):
    # MCMC_Optimizer without a device runs on the card: 64 chains of the
    # tutorial joint with vp/vs inverted and the mantle prior, through
    # K1 (mantle arm), K2, K3, K4 and K6, writing the .npy contract
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from bayhunter_tpu_torch import MCMC_Optimizer, bench_config
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    priors['mantle'] = (4.1, 1.8)
    ip.update(nchains=64, iter_burnin=40, iter_main=40, maxmodels=10,
              savepath=str(tmp_path))
    chip_smoke.reset_counts()
    opt = MCMC_Optimizer(targets, ip, priors, random_seed=3)
    assert opt.device.type == 'cuda'
    opt.mp_inversion()
    counts = chip_smoke.launch_counts()
    assert all(counts[k] > 0 for k in ('K1', 'K2_rayleigh', 'K3', 'K4',
                                       'K6'))
    assert chip_smoke.check_contract(opt) == {'p1': 10, 'p2': 10}
    assert opt.final_states.vpvs.device.type == 'cuda'


# K1's dispersion sets: (iwave, flsph) per dispersion target — the
# spherical set alone, beside the flat set, with the spherical Love
# density plane, and the six-target joint's four of each flattening
SWD_SPECS = {'sph': ((2, 1),), 'flat_sph': ((2, 0), (2, 1)),
             'sph_love': ((2, 1), (1, 1)),
             'six_sph': ((2, 1), (2, 1), (1, 1), (1, 1)),
             'all': ((2, 0), (1, 0), (2, 1), (1, 1))}


def _spherical_bitwise(dev, nuclei, priors, rf_specs, swd_specs):
    """K1 with ``swd_specs`` against its twin bit for bit, into NaN-filled
    memory: validity, each target's (props, cm, bx, top, rho) and the RF
    operand sets.  Returns the kernel's per-target operands."""
    _poison(dev)
    before = prep.model_operands.sph_launches
    kv, ksw, krf = prep.model_operands(*nuclei, priors, rf_specs,
                                       swd_specs)
    assert prep.model_operands.sph_launches == before + 1
    pv, psw, prf = prep.model_operands_plain(*nuclei, priors, rf_specs,
                                             swd_specs)
    assert torch.equal(kv, pv)
    assert len(ksw) == len(psw) == len(swd_specs)
    for kt, pt, (iwave, flsph) in zip(ksw, psw, swd_specs):
        assert (kt[4] is None) == (pt[4] is None) == (
            not (iwave == 1 and flsph == 1))
        for a, b in zip(kt, pt):
            if a is not None:
                assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(sum(krf, ()), sum(prf, ())):
        assert torch.equal(a, b)
    return ksw


@pytest.mark.parametrize('sets', sorted(SWD_SPECS))
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_model_operands_spherical_bitwise(dev, C, sets):
    # K1's spherical arm (prep_sph_kernel) with 0, 1 and 2 RF targets,
    # with the velocity-zone limits and the mantle prior
    nuclei = _nuclei(dev, C)
    specs = SWD_SPECS[sets]
    for priors, rf_specs in ((PRIORS, ()), (PRIORS_ZONES, RF_P),
                             (PRIORS._replace(mantle=(4.1, 1.8)),
                              RF_SPECS4[:2])):
        ksw = _spherical_bitwise(dev, nuclei, priors, rf_specs, specs)
    # the flattening moved the spherical set off the flat one, and the
    # Love density plane off the Rayleigh one
    flat = prep.model_operands_plain(*nuclei, PRIORS, ())[1]
    for (props, _, _, _, rho), (iwave, flsph) in zip(ksw, specs):
        if flsph and C > 1:
            assert not torch.equal(props, flat[0])
            if rho is not None:
                assert not torch.equal(rho, props[3 * NL:])


def _group_starts(planes, periods, iwave):
    """(omegas (2R,), c_prev, slopes (C, 2R)) of a group solve: the cold
    group roots moved off the DDC grid where found, mid-range where
    not."""
    layers = tuple(x.T.contiguous() for x in planes)
    _, _, roots, slopes = swd.surfdisp_roots_cold(*layers, periods, iwave,
                                                  igr=1)
    cm, bx = swd.lower_bound(planes[1], planes[2], dim=0)
    mid = 0.5 * (cm + bx)[:, None].expand_as(roots)
    c_prev = torch.where(slopes != 0.0, roots + 0.0013, mid).contiguous()
    om = swd.lane_frequencies(periods, 1, planes[0].device)
    return om, c_prev, slopes, cm, bx


@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
@pytest.mark.parametrize('R', [21, 60, 65])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_walker_group_ragged_shapes_bitwise(dev, C, R, iwave):
    # K2's group arm: 2R lanes (42, 120 and 130, above a block's 128
    # threads) with 12 bisections in every move class
    planes, top = _ragged_planes(dev, C)
    props = torch.cat(planes).contiguous()
    periods = np.linspace(1.0, 60.0, R).astype(np.float32)
    om, c_prev, slopes, cm, bx = _group_starts(planes, periods, iwave)
    assert c_prev.shape == (C, 2 * R)
    args = (props, om, c_prev, cm, bx, top)
    for st in (swd.WARM_VS, swd.WARM_Z, swd.WARM_DIM):
        kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
                  nbisect=swd.GROUP_NBISECT,
                  newton_iters=st['newton_iters'],
                  newton_maxshift=swd.NEWTON_MAXSHIFT, iwave=iwave,
                  slope_prev=slopes if st['cached_slope'] else None)
        before = walk.warm_roots_walk.group_launches
        _poison(dev)
        kc, kf, ks = walk.warm_roots_walk(*args, group=True, **kw)
        assert walk.warm_roots_walk.group_launches == before + 1
        pc, pf, ps = walk.warm_roots_walk_plain(*args, **kw)
        assert torch.equal(kf, pf)
        assert torch.equal(kc, pc)
        assert torch.equal(ks, ps)


@pytest.mark.parametrize('C', [1, 37, 10237])
def test_walker_spherical_bitwise(dev, C):
    # K2 on K1's spherical set: Rayleigh on its planes, Love on planes 0
    # and 2 with the Love density plane, phase and group lanes
    nuclei = _nuclei(dev, C)
    _, ((props, cm, bx, top, _), (_, _, _, _, rho_l)), _ = \
        prep.model_operands(*nuclei, PRIORS, (), ((2, 1), (1, 1)))
    periods = np.linspace(1.0, 41.0, 21).astype(np.float32)
    layers = [props[k * NL:(k + 1) * NL] for k in range(4)]
    for iwave, rho in ((2, None), (1, rho_l)):
        planes = layers[:3] + [layers[3] if rho is None else rho]
        for igr in (0, 1):
            _, _, roots, slopes = swd.surfdisp_roots_cold(
                *(x.T.contiguous() for x in planes), periods, iwave,
                igr=igr)
            mid = 0.5 * (cm + bx)[:, None].expand_as(roots)
            c_prev = torch.where(slopes != 0.0, roots + 0.0013,
                                 mid).contiguous()
            args = (props, swd.lane_frequencies(periods, igr, dev), c_prev,
                    cm, bx, top)
            for st in (swd.WARM_VS, swd.WARM_Z, swd.WARM_DIM):
                kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
                          nbisect=swd.GROUP_NBISECT if igr
                          else st['nbisect'],
                          newton_iters=st['newton_iters'],
                          newton_maxshift=swd.NEWTON_MAXSHIFT, iwave=iwave,
                          slope_prev=slopes if st['cached_slope'] else None,
                          rho=rho)
                _poison(dev)
                kc, kf, ks = walk.warm_roots_walk(*args, **kw)
                pc, pf, ps = walk.warm_roots_walk_plain(*args, **kw)
                assert torch.equal(kf, pf)
                assert torch.equal(kc, pc)
                assert torch.equal(ks, ps)
                if C > 1:
                    assert float(kf.float().mean()) > 0.5


def test_public_forward_defaults_to_the_card(dev):
    # surfdisp, SurfDisp and SynRF without a device run on the card
    # (K4, K5, K6, K3), and match the tutorial goldens
    import os
    from bayhunter_tpu_torch import Targets
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'fixtures')
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    cg, err = swd.surfdisp(h, vp, vs, rho, np.linspace(1, 41, 21), igr=1)
    assert cg.device.type == 'cuda' and not bool(err)
    for cls, ref, tol in (
            (Targets.RayleighDispersionPhase, 'rdispph', 1e-4),
            (Targets.RayleighDispersionGroup, 'rdispgr', 5e-4),
            (Targets.LoveDispersionPhase, 'ldispph', 1e-4),
            (Targets.LoveDispersionGroup, 'ldispgr', 1e-3),
            (Targets.PReceiverFunction, 'prf', 2e-4),
            (Targets.SReceiverFunction, 'srf', 1e-4)):
        obs = np.loadtxt(os.path.join(fx, 'st3_%s.dat' % ref))
        before = (swd.secular4.launches + swd.secular1.launches
                  + resp.resp.launches)
        x, y = cls(obs[:, 0], None).moddata.plugin.run_model(h, vp, vs,
                                                             rho)
        assert (swd.secular4.launches + swd.secular1.launches
                + resp.resp.launches) > before
        assert float(np.abs(y - obs[:, 1]).max()) <= tol, ref


# ----------------------------------------------------------------------
# the receiver-function forms: K6's unflattened arm, K3's and K3r's
# options arms, K1's layer planes for a custom target


@pytest.mark.parametrize('C', [1, 37, 10237])
def test_rf_operands_unflattened_bitwise(dev, C):
    # K6's rf_prep_kernel<false> into NaN-filled memory, P and SV
    planes, _ = _ragged_planes(dev, C, water=False)
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        _poison(dev)
        before = (prep.rf_operands.launches,
                  prep.rf_operands.unflat_launches)
        kc, kp = prep.rf_operands(*planes, P_SKM, wave, flattening=False)
        assert (prep.rf_operands.launches,
                prep.rf_operands.unflat_launches) == (before[0] + 1,
                                                      before[1] + 1)
        pc, pp = prep.rf_operands_plain(*planes, P_SKM, wave,
                                        flattening=False)
        assert torch.equal(kc, pc) and torch.equal(kp, pp)
        off = rf.pack_offsets(NL)
        assert torch.equal(kp[off['h']:off['h'] + NL], planes[0])


@pytest.mark.parametrize('q', [False, True], ids=['K3', 'K3r'])
@pytest.mark.parametrize('options', [1, 2, 3])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_response_options_bitwise(dev, C, options, q):
    # K3's and K3r's options arms at F = 1, 99, 257 lanes, P and SV, on
    # K6's operands of models whose skip depth runs over 0..NL-2, into
    # NaN-filled memory
    planes, _ = _ragged_planes(dev, C, water=False)
    qp, qs = _ragged_q(dev, C)
    wrapper = resp.resp_q if q else resp.resp
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        coefs, pack = prep.rf_operands(*planes, P_SKM, wave)
        for F in (1, 99, 257):
            _poison(dev)
            before = wrapper.option_launches[wave][options]
            if q:
                args = (coefs, pack, qp, qs, F, 512, 5.0, wave, rf.FREF,
                        options)
                ko, po = resp.resp_q(*args), resp.resp_q_plain(*args)
            else:
                args = (coefs, pack, F, 512, 5.0, wave, options)
                ko, po = resp.resp(*args), resp.resp_plain(*args)
            assert wrapper.option_launches[wave][options] == before + 1
            for a, b in zip(ko, po):
                assert a.shape == (C, F)
                assert bool(torch.isfinite(a).all())
                assert torch.equal(a, b)
    # each arm computes something else than arm 0
    if C > 1:
        args = (coefs, pack, 99, 512, 5.0, rf.SV_WAVE)
        assert not torch.equal(resp.resp(*args, options=options)[0],
                               resp.resp(*args)[0])


@pytest.mark.parametrize('sets', ['none', 'flat', 'sph', 'sph_love'])
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_model_operands_layer_planes_bitwise(dev, C, sets):
    # K1 with a custom target: the layered (h, vp, vs, rho) planes beside
    # every other output, without dispersion targets, with a flat one,
    # and with spherical ones only (the spherical kernel then writes the
    # flat set it otherwise skips), into NaN-filled memory
    nuclei = _nuclei(dev, C)
    swd_specs = {'none': (), 'flat': ((2, 0),), 'sph': ((2, 1),),
                 'sph_love': ((2, 1), (1, 1))}[sets]
    for priors, rf_specs in ((PRIORS, ()), (PRIORS_ZONES, RF_P),
                             (PRIORS._replace(mantle=(4.1, 1.8)),
                              RF_SPECS4[:2])):
        _poison(dev)
        before = prep.model_operands.layer_launches
        kv, ksw, krf, klay = prep.model_operands(*nuclei, priors, rf_specs,
                                                 swd_specs, layers=True)
        assert prep.model_operands.layer_launches == before + 1
        pv, psw, prf, play = prep.model_operands_plain(
            *nuclei, priors, rf_specs, swd_specs, layers=True)
        assert torch.equal(kv, pv)
        for a, b in zip(klay, play):
            assert a.shape == (NL, C) and torch.equal(a, b)
        for kt, pt in zip(ksw, psw):
            for a, b in zip(kt, pt):
                if a is not None:
                    assert torch.equal(a, b)
        for a, b in zip(sum(krf, ()), sum(prf, ())):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the float64 instances of K4, K5, K6 and K3 (the per-chain ring path of
# float64 runs): bit for bit against their twins run in float64, into
# NaN-filled memory, at ragged shapes; mismatched dtypes refused
# ----------------------------------------------------------------------

F64 = torch.float64
# K4/K5's float64 grids: the ring's trip 0 at ring 16 (33 points), the
# refinement (17), the dimension ring's first blocks (3, 5) and a wide one
SECULAR_SHAPES_F64 = ((21, 33), (21, 17), (21, 3), (60, 5))


@pytest.mark.parametrize('R,K', SECULAR_SHAPES_F64)
@pytest.mark.parametrize('C', [1, 37, 10237])
def test_secular_float64_bitwise(dev, C, R, K):
    planes, _ = _ragged_planes(dev, C)
    layers = tuple(x.T.contiguous().to(F64) for x in planes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(C + R + K)
    c = 2.0 + 2.8 * torch.rand((C, R, K), generator=gen, device=dev,
                               dtype=F64)
    omega = swd.angular_frequencies(np.linspace(1.0, 60.0, R), dev, F64)
    for iwave, counter in ((2, swd.secular4), (1, swd.secular1)):
        _poison(dev)
        before = counter.launches, counter.f64_launches
        k = swd.secular_at(c, omega[None, :, None], *layers, iwave)
        assert (counter.launches, counter.f64_launches) == (
            before[0], before[1] + 1)
        p = swd.secular_values(omega[None, :, None] / c, omega[None, :, None],
                               *layers, iwave)
        assert k.dtype == F64 and bool(torch.isfinite(p).all())
        assert torch.equal(k, p)


@pytest.mark.parametrize('C', [1, 37, 10237])
def test_rf_operands_and_response_float64_bitwise(dev, C):
    planes, _ = _ragged_planes(dev, C, water=False)
    planes = tuple(x.to(F64) for x in planes)
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        _poison(dev)
        before = prep.rf_operands.launches, prep.rf_operands.f64_launches
        kc, kp = prep.rf_operands(*planes, P_SKM, wave)
        assert (prep.rf_operands.launches, prep.rf_operands.f64_launches) \
            == (before[0], before[1] + 1)
        pc, pp = prep.rf_operands_plain(*planes, P_SKM, wave)
        assert kc.dtype == F64
        assert torch.equal(kc, pc) and torch.equal(kp, pp)
        for F in (1, 99, 257):
            for options in (0, 3):
                _poison(dev)
                before = resp.resp.launches, resp.resp.f64_launches
                ko = resp.resp(kc, kp, F, 512, 5.0, wave, options)
                assert (resp.resp.launches, resp.resp.f64_launches) == (
                    before[0], before[1] + 1)
                po = resp.resp_plain(kc, kp, F, 512, 5.0, wave, options)
                for a, b in zip(ko, po):
                    assert a.dtype == F64 and bool(torch.isfinite(a).all())
                    assert torch.equal(a, b)


def test_mismatched_dtypes_are_refused(dev):
    planes, _ = _ragged_planes(dev, 37, water=False)
    layers = tuple(x.T.contiguous() for x in planes)
    omega = swd.angular_frequencies(np.linspace(1.0, 60.0, 21), dev)
    c = torch.full((37, 21, 3), 3.0, device=dev)
    with pytest.raises(TypeError):      # float64 candidates, float32 layers
        swd.secular_at(c.to(F64), omega[None, :, None], *layers, 2)
    with pytest.raises(TypeError):      # float32 candidates, float64 layers
        swd.secular_at(c, omega[None, :, None],
                       *(x.to(F64) for x in layers), 1)
    with pytest.raises(TypeError):
        prep.rf_operands(planes[0].to(F64), *planes[1:], P_SKM)
    coefs, pack = prep.rf_operands(*planes, P_SKM)
    with pytest.raises(TypeError):
        resp.resp(coefs.to(F64), pack, 99, 512, 5.0)
    qp, qs = _q_planes(dev, 37)
    with pytest.raises(TypeError):      # K3r runs float32 only
        resp.resp_q(coefs.to(F64), pack.to(F64), qp.to(F64), qs.to(F64),
                    99, 512, 5.0)


def test_float64_optimizer_runs_the_ring_path_on_the_card(dev, tmp_path):
    # a float64 MCMC_Optimizer without a device: the ring path's float64
    # kernels (K4, K6, K3 at all lanes), no float32 launch and no K1/K2
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from bayhunter_tpu_torch import MCMC_Optimizer, bench_config, ops
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=64, iter_burnin=24, iter_main=24, maxmodels=8,
              savepath=str(tmp_path))
    chip_smoke.reset_counts()
    opt = MCMC_Optimizer(targets, ip, priors, random_seed=3, dtype=F64)
    assert opt.device.type == 'cuda' and not opt.eval_fn.batch
    opt.mp_inversion()
    raw = ops.launch_counts()
    assert raw['swd.secular4']['f64_launches'] > 0
    assert raw['prep.rf_operands']['f64_launches'] > 0
    assert raw['resp.resp']['f64_launches'] > 0
    for key in ('prep.model_operands', 'walk.warm_roots_walk', 'resp.resp',
                'swd.secular4', 'prep.rf_operands'):
        assert raw[key]['launches'] == 0, key
    assert chip_smoke.check_contract(opt) == {'p1': 8, 'p2': 8}
    st = opt.final_states
    assert st.vs.dtype == F64 and st.vs.device.type == 'cuda'
    assert bool(torch.isfinite(st.logL).all())
