"""The port's r_RF estimation tools (``bayhunter_tpu_torch/utils.py``)
against the JAX package's (``bayhunter_tpu/utils.py:62-201``): the
spectrum, the Gauss filter curve, the envelope and the fitted widths
equal, from the same seed (both modules' ``rstate`` reset to
``RandomState(333)``), with a small number of noise draws."""

import numpy as np

from bayhunter_tpu import utils as jutils
from bayhunter_tpu_torch import utils


def test_spectrum_and_filter_curve_match_jax():
    y = np.random.RandomState(2).normal(size=201)
    for a, b in zip(utils.compute_spectrum(y, 5.0),
                    jutils.compute_spectrum(y, 5.0)):
        assert np.array_equal(a, b)
    f = np.linspace(0.0, 2.5, 50)
    assert np.array_equal(utils.gauss_fct(1.5, f), jutils.gauss_fct(1.5, f))


def test_rrf_estimate_matches_jax(monkeypatch):
    pars = {'rfx': np.linspace(-5, 35, 201), 'draws': 200,
            'rrfs': [0.97, 0.95, 0.99]}
    monkeypatch.setattr(utils, 'rstate', np.random.RandomState(333))
    monkeypatch.setattr(jutils, 'rstate', np.random.RandomState(333))
    rrfs, a_est = utils.rrf_estimate(pars=pars)
    rrfs_j, a_est_j = jutils.rrf_estimate(pars=pars)
    assert np.array_equal(rrfs, rrfs_j) and list(rrfs) == [0.95, 0.97,
                                                           0.99]
    assert a_est == a_est_j
    assert all(np.isfinite(a_est)) and a_est[0] > a_est[-1] > 0
