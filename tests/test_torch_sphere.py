"""The spherical earth: the port's flattenings and spherical solves
against the JAX package (CPU, float32).

  * ``swd.sphere_flatten_T`` (the cold path's, ``tmp ** ex``) against
    ``bayhunter_tpu/ops/swd.py`` ``sphere_flatten_T``;
  * K1's spherical arm — its twin ``prep.model_operands_plain`` with
    (iwave, flsph) specs — against ``pallas_prep.model_operands_t`` with
    ``('swd', 2, 1), ('swd', 1, 1)`` specs in interpret mode: the
    validity bitwise, the Rayleigh set [d; a; b; rho], the Love stack
    [d; b; rho_L] (planes 0 and 2 of the spherical set and the Love
    density plane), cm, betmx and top;
  * the cold spherical phase velocities of ``swd.surfdisp_batch``
    against the JAX ``surfdisp`` (``iflsph=1``), Rayleigh and Love.

Tolerance of the flattened planes: the JAX package's K1 tolerance,
3e-6 (``tests/test_model_kernel.py:113``), for velocities, densities,
cm and betmx; 6e-6 for the flattened thickness, which is R ln(R / r)
taken at a layer's bottom and top and subtracted (ROADMAP Queue 3): the
two packages' float32 log differ in the last place, and R = 6370 times
one ulp of ln(R / (R - z)) at z <= 60 km (9.3e-10) is 5.9e-6.  Phase
velocities at the phase-root tolerance of ``tests/test_torch_love.py``
(p90 2e-5, max 5e-4).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu.ops import swd as jswd  # noqa: E402
from bayhunter_tpu.ops.pallas_prep import model_operands_t  # noqa: E402
from bayhunter_tpu_torch.ops import prep, swd  # noqa: E402
from bayhunter_tpu_torch.ops import voronoi as tvor  # noqa: E402
from test_pallas import _assert_roots_close  # noqa: E402
from test_torch_kernels import CFGT, NL, _ensemble, _t  # noqa: E402

D_TOL = 6e-6


def _close(a, b, atol=3e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _close_set(a, b, planes=4):
    """A stacked set's thickness plane at ``D_TOL``, the rest at 3e-6."""
    a, b = np.asarray(a), np.asarray(b)
    _close(a[:NL], b[:NL], D_TOL)
    _close(a[NL:planes * NL], b[NL:planes * NL])


def _layers():
    return tvor.voronoi_to_layers_T(*(_t(x) for x in _ensemble()))


@pytest.mark.parametrize('iwave', [2, 1])
def test_sphere_flatten_matches_jax(iwave):
    layers = _layers()
    port = swd.sphere_flatten_T(*layers, iwave)
    ref = jswd.sphere_flatten_T(*(jnp.asarray(x.numpy()) for x in layers),
                                iwave)
    _close(port[0].numpy(), ref[0], D_TOL)
    for a, b in zip(port[1:], ref[1:]):
        _close(a.numpy(), b)
    # the row-major form is the transposed one; padded slots keep zero
    # thickness, the halfspace slot too
    rows = swd.sphere_flatten(*(x.T.contiguous() for x in layers), iwave)
    for a, b in zip(rows, port):
        assert torch.equal(a, b.T)
    d = port[0].numpy()
    assert np.all(d[layers[0].numpy() == 0.0] == 0.0)


def test_spherical_model_operands_twin_matches_jax():
    # the spherical specs alone (the flat set and the RF sets of the same
    # kernel are held by tests/test_torch_kernels.py)
    vs_t, z_t, n, vpvs = _ensemble()
    jv, res = model_operands_t(*(jnp.asarray(x) for x in (vs_t, z_t, n,
                                                          vpvs)),
                               (('swd', 2, 1), ('swd', 1, 1)), CFGT,
                               interpret=True)
    nuclei = (_t(vs_t), _t(z_t), _t(n), _t(vpvs))
    priors = prep.ModelPriors(*CFGT)
    tv, tsw, _ = prep.model_operands(*nuclei, priors, (),
                                     ((2, 1), (1, 1)))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    (rp, rcm, rbx, rtop), (lp, lcm, lbx, ltop) = (
        tuple(np.asarray(x) for x in r) for r in res)
    (sprops, cm, bx, top, rho), (lprops, lcm_t, lbx_t, ltop_t, rho_l) = tsw
    assert rho is None
    _close_set(sprops.numpy(), rp)
    # the spherical set lies off the flat one
    fprops = prep.model_operands(*nuclei, priors, ())[1][0]
    assert np.abs(sprops.numpy()[:NL] - fprops.numpy()[:NL]).max() > 0.01
    for a, b in ((cm, rcm), (bx, rbx), (lcm_t, lcm), (lbx_t, lbx)):
        _close(a.numpy(), b)
    assert np.array_equal(top.numpy(), rtop)
    assert np.array_equal(ltop_t.numpy(), ltop)
    # the Love stack [d; b; rho_L]: the spherical set's d and b (shared
    # with Rayleigh) and the Love density plane
    assert torch.equal(lprops, sprops)
    lp = lp.reshape(3, NL, -1)
    planes = sprops.numpy().reshape(4, NL, -1)
    _close(planes[0], lp[0], D_TOL)
    _close(planes[2], lp[1])
    _close(rho_l.numpy(), lp[2])
    assert np.abs(rho_l.numpy() - planes[3]).max() > 1e-3


@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
def test_spherical_cold_solve_matches_jax(iwave):
    layers = tuple(x.T.contiguous() for x in _layers())
    periods = np.linspace(1, 41, 21).astype(np.float32)
    cg, err = swd.surfdisp_batch(*layers, periods, iwave=iwave, iflsph=1,
                                 device='cpu')
    fn = jax.vmap(lambda h, a, b, r: jswd.surfdisp(
        h, a, b, r, jnp.asarray(periods), iwave=iwave, iflsph=1))
    cj, ej = fn(*(jnp.asarray(x.numpy()) for x in layers))
    ok = ~err.numpy()
    assert np.array_equal(ok, ~np.asarray(ej))
    assert ok.sum() >= 12
    _assert_roots_close(cg.numpy()[ok], np.asarray(cj)[ok])
    # sphericity raises the long-period velocities
    flat, _ = swd.surfdisp_batch(*layers, periods, iwave=iwave,
                                 device='cpu')
    assert np.all((cg - flat).numpy()[ok, -1] > 0.0)
