"""The port's Targets host API, forward plugins and SynthObs against the
JAX package (CPU; the plugins run the kernels' plain twins with
``device='cpu'``): ports of the cases of ``tests/test_targets.py``, the
tutorial's target and plugin calls (``tutorial/tutorialhunt.py:60-63``)
and ``SynthObs.return_swddata``/``return_rfdata`` against the JAX
package's outputs on the same inputs.

Tolerances: the dispersion goldens at the JAX package's own
(``tests/test_swd.py:35-36``: 1e-4 phase, 5e-4 Rayleigh group, 1e-3
Love group), the P-RF golden at ``tests/test_targets.py:37``'s 2e-4 and
the S-RF golden at 1e-4 (``chip_smoke.py`` ``check_golden``); the
SynthObs data against the JAX package (float64 under the test suite's
x64) at the same bounds, both being within them of the goldens.
"""

import logging
import os

import numpy as np
import pytest

from bayhunter_tpu_torch import Targets
from bayhunter_tpu_torch.forward import RFminiModRF, SurfDisp, SynRF
from bayhunter_tpu_torch.synthobs import SynthObs

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
TOLS = {'rdispph': 1e-4, 'rdispgr': 5e-4, 'ldispph': 1e-4,
        'ldispgr': 1e-3, 'prf': 2e-4, 'srf': 1e-4}
CLASSES = {'rdispph': Targets.RayleighDispersionPhase,
           'rdispgr': Targets.RayleighDispersionGroup,
           'ldispph': Targets.LoveDispersionPhase,
           'ldispgr': Targets.LoveDispersionGroup,
           'prf': Targets.PReceiverFunction,
           'srf': Targets.SReceiverFunction}


@pytest.fixture(scope='module')
def tutorial():
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    vp = vs * 1.73
    return dict(h=np.array([5., 23., 8., 0.]), vs=vs, vpvs=1.73, vp=vp,
                rho=vp * 0.32 + 0.77)


def _golden(ref):
    return np.loadtxt(os.path.join(FIXTURES, 'st3_%s.dat' % ref))


@pytest.mark.parametrize('ref', sorted(TOLS))
def test_plugin_golden(tutorial, ref):
    obs = _golden(ref)
    target = CLASSES[ref](x=obs[:, 0], y=None)
    plugin = target.moddata.plugin
    assert isinstance(plugin, SynRF if ref in ('prf', 'srf') else SurfDisp)
    xmod, ymod = plugin.run_model(h=tutorial['h'], vp=tutorial['vp'],
                                  vs=tutorial['vs'], rho=tutorial['rho'],
                                  device='cpu')
    assert xmod.size == obs.shape[0]
    np.testing.assert_allclose(ymod, obs[:, 1], rtol=0, atol=TOLS[ref])


def test_plugins_run_on_the_card_unless_told(tutorial):
    # no device: CUDA (raises without one); a constructor's device sticks
    import torch
    from bayhunter_tpu_torch.ops import swd
    plugin = SurfDisp(np.linspace(1, 41, 21), 'rdispph')
    assert plugin.device is None
    if not torch.cuda.is_available():
        args = (tutorial['h'], tutorial['vp'], tutorial['vs'],
                tutorial['rho'])
        for fn in (plugin.run_model,
                   SynRF(np.linspace(-5, 35, 201), 'prf').run_model,
                   lambda *a: swd.surfdisp(*a, np.linspace(1, 41, 21))):
            with pytest.raises((AssertionError, RuntimeError)):
                fn(*args)
    assert SynRF(np.linspace(-5, 35, 201), 'prf', device='cpu').device \
        == 'cpu'
    assert RFminiModRF is SynRF
    with pytest.raises(ReferenceError):
        SurfDisp(np.arange(3.0), 'prf')


def test_surfdisp_more_than_60_periods_interpolates(tutorial):
    # 81 periods: solved at 60 evenly spaced, interpolated to the 81, as
    # the JAX plugin does (the phase tolerance, 1e-4)
    from bayhunter_tpu.forward.swd_plugin import SurfDisp as JaxSurfDisp
    x = np.linspace(1, 41, 81)
    plugin = SurfDisp(x, 'rdispph', device='cpu')
    assert plugin.obsx_int.size == 60
    args = (tutorial['h'], tutorial['vp'], tutorial['vs'], tutorial['rho'])
    xmod, ymod = plugin.run_model(*args)
    xj, yj = JaxSurfDisp(x, 'rdispph').run_model(*args)
    assert np.array_equal(xmod, x) and np.array_equal(xj, x)
    np.testing.assert_allclose(ymod, yj, rtol=0, atol=1e-4)


def test_surfdisp_failure_returns_nan():
    # no Love waves in a pure halfspace (surfdisp96.f:318-323)
    vs = np.array([4.0])
    plugin = SurfDisp(np.linspace(1, 41, 21), 'ldispph', device='cpu')
    x, y = plugin.run_model(np.array([0.0]), vs * 1.73, vs,
                            vs * 1.73 * 0.32 + 0.77)
    assert np.isnan(x) and np.isnan(y)


def test_tutorial_target_and_plugin_calls():
    # tutorial/tutorialhunt.py:60-63, unchanged
    xsw, ysw = _golden('rdispph').T
    xrf, yrf = _golden('prf').T
    target1 = Targets.RayleighDispersionPhase(xsw, ysw, yerr=ysw * 0.01)
    target2 = Targets.PReceiverFunction(xrf, yrf)
    target2.moddata.plugin.set_modelparams(gauss=1., water=0.01, p=6.4)
    targets = Targets.JointTarget(targets=[target1, target2])
    assert targets.ntargets == 2
    assert target2.moddata.plugin.modelparams == {
        'wtype': 'P', 'gauss': 1.0, 'p': 6.4, 'water': 0.01, 'nsv': None}
    assert target1.moddata.plugin.modelparams == {'mode': 1, 'flsph': 0}
    assert not hasattr(Targets.SingleTarget, 'set_modelparams')
    assert target2.moddata.plugin.nsamp == 512
    assert target2.moddata.plugin.fsamp == pytest.approx(5.0)
    assert target2.moddata.plugin.tshft == pytest.approx(5.0)


def test_modeled_data_for_an_unknown_ref(caplog):
    with caplog.at_level(logging.INFO, logger='bayhunter_tpu_torch.Targets'):
        target = Targets.SingleTarget(np.arange(4.0), np.zeros(4), 'mine')
    assert target.moddata.plugin is None and target.moddata.xlabel == 'x'
    assert 'update_plugin' in caplog.text
    assert np.isnan(target.moddata.x) and np.isnan(target.moddata.y)


def test_joint_evaluate_sentinels(tutorial):
    """Invalid forward output maps to the reference sentinels
    (src/Targets.py:325-328)."""
    obs = _golden('rdispph')
    target = Targets.RayleighDispersionPhase(x=obs[:, 0], y=obs[:, 1])
    target.get_covariance = target.valuation.get_covariance_nocorr
    joint = Targets.JointTarget([target])

    class FailingPlugin:
        def run_model(self, h, vp, vs, rho, **kw):
            return np.nan, np.nan

    target.update_plugin(FailingPlugin())
    joint.evaluate(h=tutorial['h'], vp=tutorial['vs'] * 1.73,
                   vs=tutorial['vs'], noise=np.array([0.0, 0.01]))
    assert joint.proposallikelihood == -1e15
    assert joint.proposalmisfits[0] == 1e15
    target.calc_misfit()
    target.calc_likelihood(np.eye(21), 0.0)
    assert target.valuation.misfit == 1e15
    assert target.valuation.likelihood == -1e15


def test_joint_evaluate_truth_likelihood(tutorial):
    """At the truth model with noise-free data: misfit ~ 0 and the
    ideal likelihood -n/2 log(2 pi sigma^2); the plugin on the CPU."""
    obs = _golden('rdispph')
    target = Targets.RayleighDispersionPhase(x=obs[:, 0], y=obs[:, 1])
    target.moddata.plugin.device = 'cpu'
    target.get_covariance = target.valuation.get_covariance_nocorr
    joint = Targets.JointTarget([target])
    joint.evaluate(h=tutorial['h'], vp=tutorial['vp'], vs=tutorial['vs'],
                   noise=np.array([0.0, 0.012]))
    assert joint.proposalmisfits[-1] < 1e-3
    ideal = -0.5 * 21 * np.log(2 * np.pi) - 21 * np.log(0.012)
    assert abs(joint.proposallikelihood - ideal) < 1.0
    c_inv, logc_det = target.valuation.get_covariance_nocorr(0.012, 21)
    target.calc_likelihood(c_inv, logc_det)
    assert target.valuation.likelihood == pytest.approx(
        joint.proposallikelihood, rel=1e-12)


def test_custom_target_plugin_protocol():
    """templates/-style user plugin drop-in
    (reference: src/Targets.py:46-49, templates/myfwd.py)."""
    x = np.linspace(0, 10, 11)

    class MyForward:
        def run_model(self, h, vp, vs, rho, **kw):
            return x, np.full(11, float(np.sum(vs)))

    target = Targets.RayleighDispersionPhase(x=x, y=np.full(11, 10.1))
    target.update_plugin(MyForward())
    target.get_covariance = target.valuation.get_covariance_nocorr
    joint = Targets.JointTarget([target])
    joint.evaluate(h=np.array([1., 0.]), vp=np.array([6., 7.]),
                   vs=np.array([4., 6.1]), noise=np.array([0.0, 0.1]))
    assert abs(joint.proposalmisfits[0] - 0.0) < 1e-9


def test_gauss_covariance_matches_jax():
    from bayhunter_tpu import Targets as jtargets
    for rcond in (None, 1e-5):
        port, jax_side = Targets.Valuation(), jtargets.Valuation()
        port.init_covariance_gauss(0.9, 30, rcond=rcond)
        jax_side.init_covariance_gauss(0.9, 30, rcond=rcond)
        np.testing.assert_allclose(port.corr_inv, jax_side.corr_inv,
                                   rtol=1e-12, atol=1e-9)
        assert port.logcorr_det == pytest.approx(jax_side.logcorr_det,
                                                 rel=1e-12)
        a = port.get_covariance_gauss(0.01, 30)
        b = jax_side.get_covariance_gauss(0.01, 30)
        np.testing.assert_allclose(a[0], b[0], rtol=1e-12)
        assert a[1] == pytest.approx(b[1], rel=1e-12)


def test_synthobs_matches_jax(tutorial, tmp_path):
    from bayhunter_tpu.synthobs import SynthObs as JaxSynthObs
    x = np.linspace(1, 41, 21)
    port = SynthObs.return_swddata(tutorial['h'], tutorial['vs'],
                                   vpvs=tutorial['vpvs'], x=x,
                                   device='cpu')
    jax_data = JaxSynthObs.return_swddata(tutorial['h'], tutorial['vs'],
                                          vpvs=tutorial['vpvs'], x=x)
    assert sorted(port) == sorted(jax_data)
    for ref, (xm, ym) in port.items():
        assert np.array_equal(xm, jax_data[ref][0])
        np.testing.assert_allclose(ym, jax_data[ref][1], rtol=0,
                                   atol=TOLS[ref])
    pars = dict(gauss=1.0, p=6.4, nsv=3.0)
    port = SynthObs.return_rfdata(tutorial['h'], tutorial['vs'],
                                  vpvs=tutorial['vpvs'], pars=pars,
                                  device='cpu')
    jax_data = JaxSynthObs.return_rfdata(tutorial['h'], tutorial['vs'],
                                         vpvs=tutorial['vpvs'], pars=pars)
    for ref in ('prf', 'srf'):
        np.testing.assert_allclose(port[ref][0], jax_data[ref][0],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(port[ref][1], jax_data[ref][1],
                                   rtol=0, atol=TOLS[ref])
    # the model file through SynRF.write_startmodel, as the JAX one
    SynthObs.save_model(tutorial['h'], tutorial['vs'],
                        outfile=str(tmp_path / 'p.dat'))
    JaxSynthObs.save_model(tutorial['h'], tutorial['vs'],
                           outfile=str(tmp_path / 'j.dat'))
    assert (tmp_path / 'p.dat').read_text() == \
        (tmp_path / 'j.dat').read_text()
