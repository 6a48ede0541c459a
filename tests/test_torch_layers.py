"""PyTorch port vs the JAX package: layered model, validity, likelihood
laws and the tutorial golden forward solutions (CPU, float32)."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayhunter_tpu.ops import likelihood as jlk
from bayhunter_tpu.ops import voronoi as jvor
from bayhunter_tpu_torch.ops import _ext
from bayhunter_tpu_torch.ops import likelihood as tlk
from bayhunter_tpu_torch.ops import prep as tprep
from bayhunter_tpu_torch.ops import rf as trf
from bayhunter_tpu_torch.ops import swd as tswd
from bayhunter_tpu_torch.ops import voronoi as tvor

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
PRIORS = {'layers': (1, 20), 'vs': (2.0, 5.0), 'z': (0.0, 60.0)}


def _nuclei(C=37, nl=21, seed=1):
    rs = np.random.RandomState(seed)
    vs = rs.uniform(2.05, 4.95, (C, nl)).astype(np.float32)
    vs[1::2] = np.sort(vs[1::2], axis=1)     # half without velocity zones
    vs[::7, 1] = 5.3                         # vs-prior violations
    z = np.sort(rs.uniform(0, 62, (C, nl)), axis=1).astype(np.float32)
    z[::5, 3] = z[::5, 2] + 0.01             # thin-layer violations
    n = rs.randint(2, 10, C).astype(np.int32)
    vpvs = rs.uniform(1.6, 1.9, C).astype(np.float32)
    return vs.T.copy(), z.T.copy(), n, vpvs


@pytest.mark.parametrize('mantle', [None, (4.0, 1.8)])
def test_voronoi_and_validity_match_jax(mantle):
    vs_t, z_t, n, vpvs = _nuclei()
    j = jvor.voronoi_to_layers_T(jnp.asarray(vs_t), jnp.asarray(z_t),
                                 jnp.asarray(n), jnp.asarray(vpvs),
                                 mantle=mantle)
    t = tvor.voronoi_to_layers_T(torch.tensor(vs_t), torch.tensor(z_t),
                                 torch.tensor(n), torch.tensor(vpvs),
                                 mantle=mantle)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    for lvz, hvz in ((None, None), (0.3, None), (None, 0.5), (0.2, 0.4)):
        vj = jvor.model_is_valid_T(jnp.asarray(vs_t), jnp.asarray(z_t),
                                   jnp.asarray(n), jnp.asarray(vpvs),
                                   PRIORS, 0.1, lvz, hvz, mantle=mantle)
        vt = tvor.model_is_valid_T(torch.tensor(vs_t), torch.tensor(z_t),
                                   torch.tensor(n), torch.tensor(vpvs),
                                   PRIORS, 0.1, lvz, hvz, mantle=mantle)
        assert np.array_equal(vt.numpy(), np.asarray(vj)), (lvz, hvz)
        assert 0 < int(vt.sum()) < vt.numel()


def test_sort_by_depth_matches_jax():
    vs_t, z_t, n, _ = _nuclei(seed=4)
    rs = np.random.RandomState(5)
    z_t = rs.uniform(0, 60, z_t.shape).astype(np.float32)   # unsorted
    j = jvor.sort_by_depth_T(jnp.asarray(vs_t), jnp.asarray(z_t),
                             jnp.asarray(n))
    t = tvor.sort_by_depth_T(torch.tensor(vs_t), torch.tensor(z_t),
                             torch.tensor(n))
    for a, b in zip(j, t):
        assert np.array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize('law', ['nocorr', 'gauss', 'gauss_dof'])
def test_likelihood_laws_match_jax(law):
    # residuals drawn from the law itself (the sampler's regime: the
    # whitened misfit is O(n)), at the RF target's shape
    rs = np.random.RandomState(2)
    C, n = 16, 201
    sigma = rs.uniform(0.005, 0.02, C).astype(np.float32)
    if law == 'nocorr':
        ydiff = sigma[:, None] * rs.normal(0, 1, (C, n))
    else:
        lam, u = np.linalg.eigh(jlk.gauss_correlation_matrix(0.98, n))
        keep = lam > 1e-5 * lam.max()
        ydiff = sigma[:, None] * ((u[:, keep] * np.sqrt(lam[keep]))
                                  @ rs.normal(0, 1, (keep.sum(), C))).T
    ydiff = ydiff.astype(np.float32)
    if law == 'nocorr':
        j = jlk.loglike_nocorr(jnp.asarray(ydiff), jnp.asarray(sigma))
        t = tlk.loglike_nocorr(torch.tensor(ydiff), torch.tensor(sigma))
    else:
        kept = law == 'gauss_dof'
        wj, dj = jlk.gauss_whitener(0.98, n, rcond=1e-5, return_kept=kept)
        wt, dt = tlk.gauss_whitener(0.98, n, rcond=1e-5, return_kept=kept)
        np.testing.assert_array_equal(wt, wj)
        assert dt == dj
        wj32 = jnp.asarray(wj, jnp.float32)
        wt32 = torch.tensor(wt, dtype=torch.float32)
        if kept:
            j = jlk.loglike_gauss_white_dof(jnp.asarray(ydiff),
                                            jnp.asarray(sigma), wj32, dj)
            t = tlk.loglike_gauss_white_dof(torch.tensor(ydiff),
                                            torch.tensor(sigma), wt32, dt)
        else:
            j = jlk.loglike_gauss_white(jnp.asarray(ydiff),
                                        jnp.asarray(sigma), wj32, dj)
            t = tlk.loglike_gauss_white(torch.tensor(ydiff),
                                        torch.tensor(sigma), wt32, dt)
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32),
                               rtol=1e-6)


def _tutorial_layers(nl=21):
    h = np.zeros((1, nl), np.float32)
    h[0, :3] = [5., 23., 8.]
    vs = np.full((1, nl), 4.4, np.float32)
    vs[0, :4] = [2.7, 3.6, 3.8, 4.4]
    vp = vs * np.float32(1.73)
    rho = vp * np.float32(0.32) + np.float32(0.77)
    return tuple(torch.tensor(x) for x in (h, vp, vs, rho))


def test_tutorial_golden_dispersion_f32():
    obs = np.loadtxt(os.path.join(FIXTURES, 'st3_rdispph.dat'))
    h, vp, vs, rho = _tutorial_layers()
    cg, err, roots, _ = tswd.surfdisp_roots_cold(
        h, vp, vs, rho, obs[:, 0].astype(np.float32))
    assert not bool(err[0])
    np.testing.assert_allclose(cg[0].numpy(), obs[:, 1], rtol=0, atol=1e-4)


def test_tutorial_golden_receiver_function_f32():
    obs = np.loadtxt(os.path.join(FIXTURES, 'st3_prf.dat'))[:201]
    h, vp, vs, rho = _tutorial_layers()
    nl, nsamp, fsamp, tshift = 21, 512, 5.0, 5.0
    coefs, pack = tprep.rf_operands_plain(h.T, vp.T, vs.T, rho.T,
                                          6.4 * trf.DEG_PER_KM)
    response = trf.transmission_response(coefs, pack, nsamp // 2 + 1,
                                         nsamp, fsamp)
    rf = trf.receiver_function(response, pack, nl, nsamp, fsamp, tshift,
                               1.0)
    np.testing.assert_allclose(rf[0, :201].numpy(), obs[:, 1], rtol=0,
                               atol=1e-4)
    # the hot path's Gauss-cut DFT agrees with the full inverse
    cut = trf.gauss_cut(nsamp, fsamp, 1.0)
    dft = trf.dft_tables(cut, nsamp, fsamp, tshift, 1.0, 'cpu')
    rf_cut = trf.receiver_function(tuple(x[:, :cut] for x in response),
                                   pack, nl, nsamp, fsamp, tshift, 1.0,
                                   dft=dft)
    np.testing.assert_allclose(rf_cut[0, :201].numpy(), obs[:, 1],
                               rtol=0, atol=1e-4)


def test_pack_layout_is_defined_once():
    """The RF pack's rows are named once (rf.pack_offsets); the kernels
    get them as csrc/pack.cuh's PackLayout through _ext.PackLayout, so
    the three must list the same fields in the same order, and the twin
    must put each quantity in the row its name gives."""
    with open(os.path.join(_ext.SRC_DIR, 'pack.cuh')) as f:
        body = re.search(r'struct PackLayout \{(.*?)\};', f.read(),
                         re.S).group(1)
    header = re.findall(r'^\s*int (\w+);', body, re.M)
    nl = 21
    off = trf.pack_offsets(nl)
    assert header == [name for name, _ in _ext.PackLayout._fields_]
    assert header == list(off)
    named = sorted(off[k] for k in off if k != 'rows')
    assert named[-1] == off['depth'] < off['rows'] and off['rows'] % 8 == 0

    h, vp, vs, rho = _tutorial_layers(nl)
    p = 6.4 * trf.DEG_PER_KM
    _, pack = tprep.rf_operands_plain(h.T, vp.T, vs.T, rho.T, p)
    assert pack.shape == (off['rows'], 1)
    hf, vpf, vsf, _ = trf.flatten_model_T(h.T, vp.T, vs.T, rho.T)
    for name, plane in (('h', hf), ('vp', vpf), ('vs', vsf)):
        assert torch.equal(pack[off[name]:off[name] + nl], plane), name
    assert float(pack[off['p'], 0]) == np.float32(p)
    pt = torch.tensor(p)
    for name, mat in (('hmat', trf.displacement(pt, vpf[0], vsf[0])),
                      ('nt', trf.free_surface(pt, vpf[0], vsf[0]))):
        rows = torch.stack([x for entry in mat for x in entry])
        assert torch.equal(pack[off[name]:off[name] + 8], rows), name
    assert float(pack[off['depth'], 0]) == 2.0       # 3 layers on a halfspace
    assert not bool(pack[off['depth'] + 1:].any())
