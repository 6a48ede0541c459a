"""The configurations the port runs, with the priors and initparams of
``bench.py:76-86`` (the reference tutorial's tutorialhunt.py settings):

  * ``build`` — the main path: the tutorial joint inversion of Rayleigh
    phase dispersion and a P receiver function
    (``tests/fixtures/st3_rdispph.dat``, ``st3_prf.dat``);
  * ``build_rl_prf`` — ``tutorial_rl_prf``: the same with Love phase
    dispersion (``st3_ldispph.dat``) as a third target, the joint the
    JAX package tests in ``tests/test_pallas.py:517-575``;
  * ``build_prf_srf`` — ``tutorial_prf_srf``: the main path with an S
    receiver function (``st3_srf.dat``) as a third target.

Flat earth, fundamental mode, uncorrelated SWD noise and the
whitened-Gaussian RF law in all three; the RF targets share the
``rfnoise_*`` priors, as in the JAX package."""

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

# each configuration's targets, by the name of their observed data
# (tests/fixtures/st3_<ref>.dat)
CONFIGS = {'tutorial': ('rdispph', 'prf'),
           'tutorial_rl_prf': ('rdispph', 'ldispph', 'prf'),
           'tutorial_prf_srf': ('rdispph', 'prf', 'srf')}
TARGETS = {'rdispph': Targets.RayleighDispersionPhase,
           'ldispph': Targets.LoveDispersionPhase,
           'prf': Targets.PReceiverFunction,
           'srf': Targets.SReceiverFunction}


def initparams(iters):
    return {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
            'acceptance': (40, 45), 'thickmin': 0.1,
            'lvz': None, 'hvz': None, 'rcond': 1e-5,
            'iter_burnin': int(iters), 'iter_main': int(iters)}


def joint_target(refs=CONFIGS['tutorial'], fixtures=FIXTURES):
    """The joint target of the observed data ``refs``."""
    targets = []
    for ref in refs:
        obs = np.loadtxt(os.path.join(fixtures, 'st3_%s.dat' % ref))
        targets.append(TARGETS[ref](obs[:, 0], obs[:, 1]))
    return Targets.JointTarget(targets=targets)


def build_config(name, device, iters=2000, nl=21):
    """(sampler, evaluator) of the configuration ``name`` of CONFIGS."""
    ip = initparams(iters)
    joint = joint_target(CONFIGS[name])
    cfg = make_config(PRIORS, ip, [t.noiseref for t in joint.targets],
                      nl=nl)
    ev = build_evaluator(joint, PRIORS, ip, nl, device)
    return Sampler(ev, cfg, device), ev


def build(device, iters=2000, nl=21):
    """(sampler, evaluator) of the main-path configuration."""
    return build_config('tutorial', device, iters, nl)


def build_rl_prf(device, iters=2000, nl=21):
    """(sampler, evaluator) of ``tutorial_rl_prf``: Rayleigh phase,
    Love phase and P-RF."""
    return build_config('tutorial_rl_prf', device, iters, nl)


def build_prf_srf(device, iters=2000, nl=21):
    """(sampler, evaluator) of ``tutorial_prf_srf``: Rayleigh phase,
    P-RF and S-RF."""
    return build_config('tutorial_prf_srf', device, iters, nl)
