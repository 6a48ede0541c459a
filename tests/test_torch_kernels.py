"""Plain twins of the port's CUDA kernels vs the JAX package's Pallas
kernels (interpret mode on the CPU), float32:

  * K1 model operands vs ``pallas_prep.model_operands_t``;
  * K2 warm root walker vs ``pallas_walk.warm_roots_walk`` for the
    vs, z and dimension-move settings;
  * K3 RF response (with deconvolution and the inverse DFT) vs
    ``rf.synrf_batch``, including a batch mixing 2- and 8-layer
    models, whose per-chain skip depths differ.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu.ops.pallas_prep import model_operands_t  # noqa: E402
from bayhunter_tpu.ops.pallas_walk import warm_roots_walk  # noqa: E402
from bayhunter_tpu.ops.rf import synrf_batch  # noqa: E402
from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk  # noqa: E402
from bayhunter_tpu_torch.ops import voronoi as tvor  # noqa: E402
from test_pallas import _assert_roots_close  # noqa: E402

NL = 21
P_SKM = 6.4 * rf.DEG_PER_KM
CFGT = (1, 20, 2.0, 5.0, 0.0, 60.0, 0.1, None, None)
SPECS = (('swd', 2, 0), ('rf', P_SKM, 0, True))
NSAMP, FSAMP, TSHIFT, GAUSS = 512, 5.0, 5.0, 1.0


def _ensemble(C=16, seed=7):
    """Depth-sorted nuclei of 2-9 layer models (the distribution of
    tests/test_model_kernel.py)."""
    rs = np.random.RandomState(seed)
    n = rs.randint(2, 10, C).astype(np.int32)
    vs = np.sort(rs.uniform(2.05, 4.95, (C, NL)), axis=1)
    z = np.sort(rs.uniform(0.0, 58.0, (C, NL)), axis=1)
    for i in range(C):
        z[i, n[i]:] = 120.0 + np.arange(NL - n[i])
    vpvs = rs.uniform(1.6, 1.9, C)
    return (vs.T.astype(np.float32), z.T.astype(np.float32), n,
            vpvs.astype(np.float32))


def _jax_operands(vs_t, z_t, n, vpvs):
    valid, res = model_operands_t(jnp.asarray(vs_t), jnp.asarray(z_t),
                                  jnp.asarray(n), jnp.asarray(vpvs), SPECS,
                                  CFGT, interpret=True)
    return (np.asarray(valid), tuple(np.asarray(x) for x in res[0]),
            tuple(np.asarray(x) for x in res[1]))


def _t(x):
    return torch.tensor(np.asarray(x))


def _priors():
    return prep.ModelPriors(*CFGT)


def test_model_operands_twin_matches_jax():
    vs_t, z_t, n, vpvs = _ensemble()
    jv, jsw, jrf = _jax_operands(vs_t, z_t, n, vpvs)
    tv, tsw, (trf,) = prep.model_operands(_t(vs_t), _t(z_t), _t(n),
                                          _t(vpvs), _priors(),
                                          ((P_SKM, rf.P_WAVE),))
    assert np.array_equal(tv.numpy(), jv)
    for a, b in zip(tsw, jsw):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=3e-6)
    np.testing.assert_allclose(trf[0].numpy(), jrf[0], rtol=0, atol=3e-6)
    depth_row = rf.pack_offsets(NL)['depth']
    rows = np.arange(trf[1].shape[0]) != depth_row
    np.testing.assert_allclose(trf[1].numpy()[rows], jrf[1][rows], rtol=0,
                               atol=3e-6)
    # skip depth: the deepest layer with thickness or a contrast below
    # it.  On the CPU the JAX kernel's f32 flattening leaves padded
    # slots up to ~1e-6 km thick (XLA:CPU evaluates R ln(R/(R - z))
    # differently at the top and the bottom of one zero-thickness
    # slot), so its row may sit deeper, never shallower.
    h = tvor.voronoi_to_layers_T(_t(vs_t), _t(z_t), _t(n), _t(vpvs))[0]
    expect = np.maximum(n - 2, 0)
    assert np.array_equal(trf[1][depth_row].numpy(), expect)
    assert np.all(jrf[1][depth_row] >= expect)
    assert np.array_equal(tsw[3].numpy(),
                          np.where((h > 0).any(0).numpy(), n - 2, -1))


@pytest.mark.parametrize('move', ['vs', 'z', 'dim'])
def test_walker_twin_matches_jax(move):
    st = {'vs': swd.WARM_VS, 'z': swd.WARM_Z, 'dim': swd.WARM_DIM}[move]
    vs_t, z_t, n, vpvs = _ensemble()
    _, (props, cm, bx, top), _ = _jax_operands(vs_t, z_t, n, vpvs)
    C = vs_t.shape[1]
    periods = np.linspace(1, 41, 21).astype(np.float32)
    om = swd.angular_frequencies(periods, 'cpu')
    d, a, b, r = (_t(props[k * NL:(k + 1) * NL]).T for k in range(4))
    _, err, roots, slopes = swd.surfdisp_roots_cold(d, a, b, r, periods)
    assert not bool(err.any())
    # warm starts moved off the DDC grid, within the walk bound
    rs = np.random.RandomState(5)
    cp = (roots.numpy() + 0.0013
          + rs.uniform(-0.004, 0.004, roots.shape)).astype(np.float32)
    sl = slopes.numpy() if st['cached_slope'] else None
    kw = dict(nbisect=st['nbisect'], newton_iters=st['newton_iters'],
              newton_maxshift=swd.NEWTON_MAXSHIFT)
    cj, fj, sj = warm_roots_walk(
        None, None, None, None, jnp.broadcast_to(jnp.asarray(om), (C, 21)),
        jnp.asarray(cp), jnp.asarray(cm)[:, None], jnp.asarray(bx)[:, None],
        swd.DDC, ring_k=st['ring'], trips=swd.WARM_CAP,
        slope_prev=None if sl is None else jnp.asarray(sl), layout_t=True,
        pstack=jnp.asarray(props), top_chain=jnp.asarray(top),
        interpret=True, **kw)
    ct, ft, stp = walk.warm_roots_walk(
        _t(props), om, _t(cp), _t(cm), _t(bx), _t(top), st['ring'],
        swd.WARM_CAP, slope_prev=None if sl is None else _t(sl), **kw)
    fj = np.asarray(fj)
    assert np.array_equal(ft.numpy(), fj)
    assert fj.mean() > 0.9
    _assert_roots_close(ct.numpy()[fj], np.asarray(cj)[fj])
    assert np.array_equal(stp.numpy() == 0.0, ~fj)


def _port_rf(coefs, pack):
    cut = rf.gauss_cut(NSAMP, FSAMP, GAUSS)
    response = resp.resp(_t(coefs), _t(pack), cut, NSAMP, FSAMP)
    dft = rf.dft_tables(cut, NSAMP, FSAMP, TSHIFT, GAUSS, 'cpu')
    return rf.receiver_function(response, _t(pack), NL, NSAMP, FSAMP,
                                TSHIFT, GAUSS, dft=dft).numpy()


def _jax_rf(h, vp, vs, rho, prep_ops=None):
    off = rf.pack_offsets(NL)
    if prep_ops is not None:
        vp0 = prep_ops[1][off['vp']]
        vs0 = prep_ops[1][off['vs']]
        prep_ops = tuple(jnp.asarray(x) for x in prep_ops)
    else:
        vp0, vs0 = np.asarray(vp[0]), np.asarray(vs[0])
    vpvs0 = vp0 / vs0
    poisson = (2 - vpvs0 ** 2) / (2 - 2 * vpvs0 ** 2)
    return np.asarray(synrf_batch(
        h, vp, vs, rho, 500.0, 225.0, 6.4, GAUSS, NSAMP, FSAMP, TSHIFT,
        jnp.asarray(vs0), jnp.asarray(poisson), wave_type=0, layout_t=True,
        prep=prep_ops, interpret=True))


def test_response_twin_matches_jax():
    vs_t, z_t, n, vpvs = _ensemble()
    _, _, jrf = _jax_operands(vs_t, z_t, n, vpvs)
    a = _port_rf(*jrf)
    b = _jax_rf(None, None, None, None, prep_ops=jrf)
    assert np.abs(b).max() > 0.05
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_response_twin_mixed_depths():
    """Chains of 2 and 8 layers in one batch: each chain's recursion
    stops at its own depth (the case tests/test_pallas.py:376 guards
    for the tile-shared depth of the TPU kernel)."""
    rs = np.random.RandomState(7)
    C = 16
    H = np.zeros((C, NL), np.float32)
    VS = np.zeros((C, NL), np.float32)
    for i in range(C):
        nlay = 2 if i % 2 == 0 else 8
        H[i, :nlay - 1] = rs.uniform(2, 12, nlay - 1)
        vv = np.sort(rs.uniform(2.5, 4.5, nlay))
        VS[i] = vv[-1]
        VS[i, :nlay] = vv
    VP = VS * np.float32(1.73)
    RHO = VP * np.float32(0.32) + np.float32(0.77)
    coefs, pack = prep.rf_operands_plain(*(_t(x.T) for x in (H, VP, VS,
                                                             RHO)), P_SKM)
    depth = pack[rf.pack_offsets(NL)['depth']].numpy()
    assert np.array_equal(depth, np.where(np.arange(C) % 2 == 0, 0, 6))
    a = _port_rf(coefs.numpy(), pack.numpy())
    b = _jax_rf(*(jnp.asarray(x.T) for x in (H, VP, VS, RHO)))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
