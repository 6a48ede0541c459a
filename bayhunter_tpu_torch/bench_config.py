"""The configurations the port runs, with the priors and initparams of
``bench.py:76-86`` (the reference tutorial's tutorialhunt.py settings):

  * ``build`` — the main path: the tutorial joint inversion of Rayleigh
    phase dispersion and a P receiver function
    (``tests/fixtures/st3_rdispph.dat``, ``st3_prf.dat``);
  * ``build_rl_prf`` — ``tutorial_rl_prf``: the same with Love phase
    dispersion (``st3_ldispph.dat``) as a third target, the joint the
    JAX package tests in ``tests/test_pallas.py:517-575``;
  * ``build_prf_srf`` — ``tutorial_prf_srf``: the main path with an S
    receiver function (``st3_srf.dat``) as a third target;
  * ``build_six`` — ``tutorial_six``: every target kind of the
    reference in one joint, the six fixtures (Rayleigh and Love phase
    and group velocity, ``st3_rdispph.dat``, ``st3_rdispgr.dat``,
    ``st3_ldispph.dat``, ``st3_ldispgr.dat``, P- and S-RF), the joint
    of the JAX package's ``test_all_six_targets_joint``
    (``tests/test_sampler.py:166-198``);
  * ``build_six_sph`` — ``tutorial_six_sph``: the same with the four
    dispersion targets on a spherical earth (``flsph`` 1).

Fundamental mode, uncorrelated SWD noise and the whitened-Gaussian RF
law in all; flat earth but in ``tutorial_six_sph``; the dispersion
targets share the ``swdnoise_*`` priors and the RF targets the
``rfnoise_*`` ones, as in the JAX package."""

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
SIX = ('rdispph', 'rdispgr', 'ldispph', 'ldispgr', 'prf', 'srf')
CONFIGS = {'tutorial': ('rdispph', 'prf'),
           'tutorial_rl_prf': ('rdispph', 'ldispph', 'prf'),
           'tutorial_prf_srf': ('rdispph', 'prf', 'srf'),
           'tutorial_six': SIX,
           'tutorial_six_sph': SIX}
# the configurations whose dispersion targets take a spherical earth
SPHERICAL = ('tutorial_six_sph',)
TARGETS = {'rdispph': Targets.RayleighDispersionPhase,
           'rdispgr': Targets.RayleighDispersionGroup,
           'ldispph': Targets.LoveDispersionPhase,
           'ldispgr': Targets.LoveDispersionGroup,
           'prf': Targets.PReceiverFunction,
           'srf': Targets.SReceiverFunction}


def initparams(iters):
    return {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
            'acceptance': (40, 45), 'thickmin': 0.1,
            'lvz': None, 'hvz': None, 'rcond': 1e-5,
            'iter_burnin': int(iters), 'iter_main': int(iters)}


def joint_target(refs=CONFIGS['tutorial'], fixtures=FIXTURES, flsph=0):
    """The joint target of the observed data ``refs``, its dispersion
    targets on a flat (``flsph`` 0) or spherical (1) earth."""
    targets = []
    for ref in refs:
        obs = np.loadtxt(os.path.join(fixtures, 'st3_%s.dat' % ref))
        target = TARGETS[ref](obs[:, 0], obs[:, 1])
        if target.noiseref == 'swd':
            target.moddata.plugin.set_modelparams(flsph=flsph)
        targets.append(target)
    return Targets.JointTarget(targets=targets)


def build_config(name, device, iters=2000, nl=21):
    """(sampler, evaluator) of the configuration ``name`` of CONFIGS."""
    ip = initparams(iters)
    joint = joint_target(CONFIGS[name], flsph=int(name in SPHERICAL))
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


def build_six(device, iters=2000, nl=21):
    """(sampler, evaluator) of ``tutorial_six``: the six target kinds."""
    return build_config('tutorial_six', device, iters, nl)


def build_six_sph(device, iters=2000, nl=21):
    """(sampler, evaluator) of ``tutorial_six_sph``: the six target kinds,
    the dispersion targets on a spherical earth."""
    return build_config('tutorial_six_sph', device, iters, nl)
