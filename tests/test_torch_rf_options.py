"""The RF solver options (rfmini's synrf.h:52-53 bitmask) of the port's
``rf.synrf``, K3's and K3r's plain twins on the CPU, and the rfmini
introspection helpers, against the JAX package, float64:

  * ``synrf(options=k)``, k = 0..3, P and SV incidence, with scalar Q
    (K3's twin) and with the same Q as arrays (K3r's twin), against the
    JAX ``synrf`` with the same options: (fz, fr, rf) within 1e-10;
  * the physics checks of ``tests/test_rf.py:234-290`` on the port:
    WITHOUT_ANELASTICITY equals the Q -> inf limit (Q = 1e9) within
    1e-8 and differs from the finite-Q RF; SUPPRESS_MULTIPLES equals the
    closed form g = prod_i e_i tu_{i+1} built from the port's public
    ``interface_coefficients``, ``displacement_matrix`` and
    ``flatten_model`` (rtol 1e-10);
  * ``coeff`` (potential and displacement coefficients) and ``coeffs``
    against the JAX ones within 1e-12, sub- and post-critical, and the
    re-export from ``forward/rf_plugin.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayhunter_tpu.ops import rf as jrf
from bayhunter_tpu_torch.forward import rf_plugin
from bayhunter_tpu_torch.ops import prep, rf

NL = 6
ARGS = (6.4, 1.0, 256, 5.0, 5.0)


def _model():
    """The physics check's model of tests/test_rf.py (two layers over
    the halfspace, three padded slots), float64."""
    h = np.zeros(NL)
    h[:2] = [8.0, 20.0]
    vs = np.full(NL, 4.4)
    vs[:3] = [2.8, 3.6, 4.4]
    vp = vs * 1.73
    return h, vp, vs, vp * 0.32 + 0.77


def _synrf(model, qp, qs, wave=rf.P_WAVE, options=0):
    return rf.synrf(*(torch.tensor(x) for x in model),
                    qp if np.isscalar(qp) else torch.tensor(qp),
                    qs if np.isscalar(qs) else torch.tensor(qs), *ARGS,
                    model[2][0], 0.25, wave_type=wave, options=options,
                    device='cpu')


@pytest.mark.parametrize('options', [0, 1, 2, 3])
@pytest.mark.parametrize('wave', [rf.P_WAVE, rf.SV_WAVE], ids=['P', 'SV'])
def test_options_match_jax(wave, options):
    model = _model()
    want = jrf.synrf(*(jnp.asarray(x) for x in model), jnp.full(NL, 500.0),
                     jnp.full(NL, 225.0), *ARGS, model[2][0], 0.25,
                     wave_type=wave, options=options)
    for q in ((500.0, 225.0), (np.full(NL, 500.0), np.full(NL, 225.0))):
        got = _synrf(model, *q, wave, options)
        for a, b in zip(got, want):
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-10)


def test_elastic_is_the_infinite_q_limit():
    model = _model()
    elastic = _synrf(model, 500.0, 225.0, options=rf.WITHOUT_ANELASTICITY)
    qinf = _synrf(model, np.full(NL, 1e9), np.full(NL, 1e9))
    np.testing.assert_allclose(elastic[2].numpy(), qinf[2].numpy(),
                               rtol=0, atol=1e-8)
    anelastic = _synrf(model, 500.0, 225.0)
    assert float((elastic[2] - anelastic[2]).abs().max()) > 1e-4
    # per-layer Q does not reach the elastic arm
    q_arr = _synrf(model, np.linspace(50.0, 600.0, NL),
                   np.linspace(20.0, 300.0, NL),
                   options=rf.WITHOUT_ANELASTICITY)
    np.testing.assert_allclose(q_arr[2].numpy(), elastic[2].numpy(),
                               rtol=0, atol=1e-12)


def test_suppress_is_the_direct_transmission():
    h, vp, vs, rho = _model()
    nsamp, fsamp = ARGS[2], ARGS[3]
    nfreq = nsamp // 2 + 1
    p = ARGS[0] * rf.DEG_PER_KM
    planes = tuple(torch.tensor(x)[:, None] for x in (h, vp, vs, rho))
    coefs, pack = prep.rf_operands(*planes, p)
    czr, czi, crr, cri = rf.transmission_response(
        coefs, pack, nfreq, nsamp, fsamp, options=rf.SUPPRESS_MULTIPLES)
    hf, vpf, vsf, rhof = (x.numpy() for x in rf.flatten_model(h, vp, vs,
                                                             rho))
    w = 2.0 * np.pi * fsamp / nsamp * np.arange(nfreq)
    lgw = np.where(np.arange(nfreq) > 0,
                   np.log(np.maximum(w, 1e-30) / (2 * np.pi)), 0.0)
    g = np.broadcast_to(np.eye(2, dtype=complex), (nfreq, 2, 2)).copy()
    for i in range(NL - 1):
        vpc = vpf[i] * (1 + lgw / (np.pi * 500.0) + 1j / 1000.0)
        vsc = vsf[i] * (1 + lgw / (np.pi * 225.0) + 1j / 450.0)
        e = np.zeros((nfreq, 2, 2), complex)
        e[:, 0, 0] = np.exp(-1j * w * hf[i] * np.sqrt(1 / vpc ** 2 - p * p))
        e[:, 1, 1] = np.exp(-1j * w * hf[i] * np.sqrt(1 / vsc ** 2 - p * p))
        tu = rf.interface_coefficients(p, vpf[i], vsf[i], rhof[i],
                                       vpf[i + 1], vsf[i + 1],
                                       rhof[i + 1])[3].numpy()
        g = g @ (e @ tu)
    hmat = rf.displacement_matrix(p, vpf[0], vsf[0]).numpy()
    t = 2.0 * np.einsum('ab,fbc->fac', hmat, g)
    qv = np.sqrt(np.maximum(1 / vpf ** 2 - p * p, 0.0))
    t0 = np.sum(np.concatenate([hf[:-1], [-1.0]]) * qv)
    qq = np.exp(1j * w * t0)
    np.testing.assert_allclose((czr + 1j * czi)[0].numpy(),
                               t[:, 1, 0] * qq, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose((crr + 1j * cri)[0].numpy(),
                               t[:, 0, 0] * qq, rtol=1e-10, atol=1e-12)
    full = rf.transmission_response(coefs, pack, nfreq, nsamp, fsamp)
    assert float((full[0] - czr).abs().max()) > 1e-3


@pytest.mark.parametrize('p', [0.0, 0.06, 0.2], ids=['normal', 'sub',
                                                     'post'])
def test_coeff_and_coeffs_match_jax(p):
    media = (6.2, 3.6, 2.8, 8.0, 4.5, 3.3)
    assert rf_plugin.coeff is rf.coeff and rf_plugin.coeffs is rf.coeffs
    for dis in (0, 1):
        got = rf.coeff(p, *media, dis=dis)
        want = jrf.coeff(p, *media, dis=dis)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert all(isinstance(x, complex) for x in a)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    got, want = rf.coeffs(p, 6.2, 3.6, 2.8), jrf.coeffs(p, 6.2, 3.6, 2.8)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    assert got[1] == want[1] == complex(1.0, 0.0)
    # the SH table of the interface, with its rho and vs ratios
    sh = rf.interface_coefficients_sh(p, 3.6, 2.8, 4.5, 3.3)
    np.testing.assert_allclose(
        [complex(x) for x in sh],
        [complex(np.asarray(x)) for x in jrf.interface_coefficients_sh(
            p, 3.6, 2.8, 4.5, 3.3, jnp.complex128)], rtol=0, atol=1e-12)
