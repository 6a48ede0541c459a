"""K2's Love branch and K6 (RF operands from layer planes): the plain
twins vs the JAX package's Pallas kernels in interpret mode, float32.

  * the Love walker on the port's reuse of the model kernel's Rayleigh
    planes vs ``pallas_walk.warm_roots_walk(iwave=1)`` on the JAX model
    kernel's own Love stack, for the vs, z and dimension-move settings;
  * ``prep.rf_operands`` vs ``pallas_prep.rf_operands_t``.
"""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu.ops.pallas_prep import (  # noqa: E402
    model_operands_t, rf_operands_t)
from bayhunter_tpu.ops.pallas_walk import warm_roots_walk  # noqa: E402
from bayhunter_tpu_torch.ops import prep, rf, swd, walk  # noqa: E402
from bayhunter_tpu_torch.ops import voronoi as tvor  # noqa: E402
from test_pallas import _assert_roots_close  # noqa: E402
from test_torch_kernels import (  # noqa: E402
    CFGT, NL, P_SKM, _ensemble, _t)

SPECS_RL = (('swd', 2, 0), ('swd', 1, 0))


@pytest.mark.parametrize('move', ['vs', 'z', 'dim'])
def test_love_walker_twin_matches_jax(move):
    st = {'vs': swd.WARM_VS, 'z': swd.WARM_Z, 'dim': swd.WARM_DIM}[move]
    vs_t, z_t, n, vpvs = _ensemble()
    _, ((props, cm, bx, top), (props_l, cm_l, bx_l, top_l)) = \
        model_operands_t(*(jnp.asarray(x) for x in (vs_t, z_t, n, vpvs)),
                         SPECS_RL, CFGT, interpret=True)
    props, props_l = np.asarray(props), np.asarray(props_l)
    # flat earth: the Love stack [d; b; rho] is planes 0, 2, 3 of the
    # Rayleigh stack, with the same cm, betmx and top
    planes = props.reshape(4, NL, -1)
    assert np.array_equal(props_l.reshape(3, NL, -1), planes[[0, 2, 3]])
    for x, y in ((cm, cm_l), (bx, bx_l), (top, top_l)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    C = vs_t.shape[1]
    periods = np.linspace(1, 41, 21).astype(np.float32)
    om = swd.angular_frequencies(periods, 'cpu')
    d, a, b, r = (_t(planes[k]).T for k in range(4))
    # two of the 16 models have a top layer within a few m/s of the
    # halfspace, whose long-period Love roots the DDC grid cannot
    # bracket: their cold solves fail in both packages
    _, err, roots, slopes = swd.surfdisp_roots_cold(d, a, b, r, periods, 1)
    assert int(err.sum()) == 2
    rs = np.random.RandomState(5)
    cp = (roots.numpy() + 0.0013
          + rs.uniform(-0.004, 0.004, roots.shape)).astype(np.float32)
    sl = slopes.numpy() if st['cached_slope'] else None
    kw = dict(nbisect=st['nbisect'], newton_iters=st['newton_iters'],
              newton_maxshift=swd.NEWTON_MAXSHIFT)
    cj, fj, _ = warm_roots_walk(
        None, None, None, None, jnp.broadcast_to(jnp.asarray(om), (C, 21)),
        jnp.asarray(cp), jnp.asarray(cm)[:, None], jnp.asarray(bx)[:, None],
        swd.DDC, iwave=1, ring_k=st['ring'], trips=swd.WARM_CAP,
        slope_prev=None if sl is None else jnp.asarray(sl), layout_t=True,
        pstack=jnp.asarray(props_l), top_chain=jnp.asarray(top),
        interpret=True, **kw)
    ct, ft, stp = walk.warm_roots_walk(
        _t(props), om, _t(cp), _t(np.asarray(cm)), _t(np.asarray(bx)),
        _t(np.asarray(top)), st['ring'], swd.WARM_CAP,
        slope_prev=None if sl is None else _t(sl), iwave=1, **kw)
    fj = np.asarray(fj)
    assert np.array_equal(ft.numpy(), fj)
    assert fj[~err.numpy()].mean() > 0.95
    _assert_roots_close(ct.numpy()[fj], np.asarray(cj)[fj])
    assert np.array_equal(stp.numpy() == 0.0, ~fj)
    # the Love roots are not the Rayleigh ones of the same models
    cr, fr, _ = walk.warm_roots_walk(
        _t(props), om, _t(cp), _t(np.asarray(cm)), _t(np.asarray(bx)),
        _t(np.asarray(top)), st['ring'], swd.WARM_CAP,
        slope_prev=None if sl is None else _t(sl), iwave=2, **kw)
    both = (fr & ft).numpy()
    assert np.abs(cr.numpy() - ct.numpy())[both].max() > 0.01


def test_rf_operands_twin_matches_jax():
    vs_t, z_t, n, vpvs = _ensemble()
    layers = tvor.voronoi_to_layers_T(_t(vs_t), _t(z_t), _t(n), _t(vpvs))
    jc, jp = (np.asarray(x) for x in rf_operands_t(
        *(jnp.asarray(x.numpy()) for x in layers), P_SKM, interpret=True))
    tc, tp = (x.numpy() for x in prep.rf_operands(*layers, P_SKM))
    off = rf.pack_offsets(NL)
    assert tc.shape == jc.shape and tp.shape == jp.shape
    # within 3e-6 of each array's largest entry (the interface tables of
    # padded slots are zero up to f32 noise on both sides)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=3e-6 * np.abs(jc).max())
    rows = np.arange(tp.shape[0]) != off['depth']
    np.testing.assert_allclose(tp[rows], jp[rows], rtol=0,
                               atol=3e-6 * np.abs(jp[rows]).max())
    # skip depth: the port's is the model's own; the JAX kernel's is
    # equal wherever its flattening gives no padded slot a positive
    # thickness — on the CPU it leaves some up to ~1e-6 km thick (the
    # reference quirk of ROADMAP Queue 3), and its depth then runs
    # deeper
    assert np.array_equal(tp[off['depth']], np.maximum(n - 2, 0))
    padded = np.arange(NL)[:, None] >= (n - 1)[None, :]
    hj = jp[off['h']:off['h'] + NL]
    clean = ~(padded & (hj > 0.0)).any(axis=0)
    assert 0 < clean.sum() < clean.size
    assert np.array_equal(tp[off['depth']][clean], jp[off['depth']][clean])
    assert np.all(jp[off['depth']] >= tp[off['depth']])
