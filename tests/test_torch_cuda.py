"""CUDA kernels vs their plain twins on the card, at a small batch.

Needs an NVIDIA GPU and nvcc (marker ``cuda``); skipped elsewhere.  On
a machine with a card:  ``python -m pytest tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the same checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk

NL = 21
PRIORS = prep.ModelPriors(1, 20, 2.0, 5.0, 0.0, 60.0, 0.1, None, None)
P_SKM = 6.4 * rf.DEG_PER_KM

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
    args = _models(dev) + (PRIORS, P_SKM)
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
                                                     PRIORS, P_SKM)
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
    _, _, (coefs, pack) = prep.model_operands(*_models(dev), PRIORS, P_SKM)
    cut = rf.gauss_cut(512, 5.0, 1.0)
    ko = resp.resp(coefs, pack, cut, 512, 5.0)
    po = resp.resp_plain(coefs, pack, cut, 512, 5.0)
    scale = float(torch.maximum(po[0].abs().max(), po[1].abs().max()))
    for a, b in zip(ko, po):
        assert float((a - b).abs().max()) <= 1e-5 * scale
