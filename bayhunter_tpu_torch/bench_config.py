"""The configurations the port runs, with the priors and initparams of
``bench.py:76-86`` (the reference tutorial's tutorialhunt.py settings):

  * ``build`` — the main path: the tutorial joint inversion of Rayleigh
    phase dispersion and a P receiver function
    (``tests/fixtures/st3_rdispph.dat``, ``st3_prf.dat``);
  * ``build_rl_prf`` — ``tutorial_rl_prf``: the same with Love phase
    dispersion (``st3_ldispph.dat``) as a third target, the joint the
    JAX package tests in ``tests/test_pallas.py:517-575``.

Flat earth, fundamental mode, uncorrelated SWD noise and the
whitened-Gaussian RF law in both."""

import os

import numpy as np

from bayhunter_tpu_torch import Targets
from bayhunter_tpu_torch.sampler.chain import Sampler, make_config
from bayhunter_tpu_torch.sampler.evaluator import build_evaluator

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tests', 'fixtures')

PRIORS = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 20),
          'vpvs': 1.73, 'mohoest': None, 'mantle': None,
          'swdnoise_corr': 0.0, 'swdnoise_sigma': (1e-5, 0.05),
          'rfnoise_corr': 0.98, 'rfnoise_sigma': (1e-5, 0.02)}


def initparams(iters):
    return {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
            'acceptance': (40, 45), 'thickmin': 0.1,
            'lvz': None, 'hvz': None, 'rcond': 1e-5,
            'iter_burnin': int(iters), 'iter_main': int(iters)}


def _fixture(name, fixtures):
    return np.loadtxt(os.path.join(fixtures, name))


def joint_target(fixtures=FIXTURES, love=False):
    """Rayleigh phase and P-RF targets, with Love phase between them
    when ``love``."""
    swd = _fixture('st3_rdispph.dat', fixtures)
    prf = _fixture('st3_prf.dat', fixtures)
    targets = [Targets.RayleighDispersionPhase(swd[:, 0], swd[:, 1])]
    if love:
        lov = _fixture('st3_ldispph.dat', fixtures)
        targets.append(Targets.LoveDispersionPhase(lov[:, 0], lov[:, 1]))
    targets.append(Targets.PReceiverFunction(prf[:, 0], prf[:, 1]))
    return Targets.JointTarget(targets=targets)


def _build(device, iters, nl, love):
    ip = initparams(iters)
    joint = joint_target(love=love)
    cfg = make_config(PRIORS, ip, [t.noiseref for t in joint.targets],
                      nl=nl)
    ev = build_evaluator(joint, PRIORS, ip, nl, device)
    return Sampler(ev, cfg, device), ev


def build(device, iters=2000, nl=21):
    """(sampler, evaluator) of the main-path configuration."""
    return _build(device, iters, nl, love=False)


def build_rl_prf(device, iters=2000, nl=21):
    """(sampler, evaluator) of ``tutorial_rl_prf``: Rayleigh phase,
    Love phase and P-RF."""
    return _build(device, iters, nl, love=True)
