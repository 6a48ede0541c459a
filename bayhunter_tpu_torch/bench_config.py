"""The main-path configuration: the tutorial joint inversion of
Rayleigh phase dispersion and a P receiver function
(``tests/fixtures/st3_rdispph.dat``, ``st3_prf.dat``) with the priors
and initparams of ``bench.py:76-86`` (the reference tutorial's
tutorialhunt.py settings)."""

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


def joint_target(fixtures=FIXTURES):
    swd = np.loadtxt(os.path.join(fixtures, 'st3_rdispph.dat'))
    prf = np.loadtxt(os.path.join(fixtures, 'st3_prf.dat'))
    return Targets.JointTarget(targets=[
        Targets.RayleighDispersionPhase(swd[:, 0], swd[:, 1]),
        Targets.PReceiverFunction(prf[:, 0], prf[:, 1])])


def build(device, iters=2000, nl=21):
    """(sampler, evaluator) of the main-path configuration."""
    ip = initparams(iters)
    cfg = make_config(PRIORS, ip, ['swd', 'rf'], nl=nl)
    ev = build_evaluator(joint_target(), PRIORS, ip, nl, device)
    return Sampler(ev, cfg, device), ev
