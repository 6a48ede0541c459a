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
    dispersion targets on a spherical earth (``flsph`` 1);
  * ``build_tempered`` — ``tempered_tutorial``: the reference tutorial
    (``tutorial_targets``, ``tutorial_params``) under parallel tempering
    (``docs/parameters.md:50-53``: 4 rungs, tmax 1,000, a sweep after
    every cycle, the burn-in ladder adaptation), 2,560 posterior chains
    and so 10,240 on the device, for ``MCMC_Optimizer``;
  * ``build_tomo`` — ``tomo_1000x100``: the tomography configuration of
    ``BASELINE.json`` (configs[4]), 1,000 cells x 100 chains of Rayleigh
    phase dispersion at 12 periods, the two truth families of
    ``tests/test_tomo.py`` alternating over the cells, for
    ``parallel.TomoInversion``.

Fundamental mode, uncorrelated SWD noise and the whitened-Gaussian RF
law in all; flat earth but in ``tutorial_six_sph``; the dispersion
targets share the ``swdnoise_*`` priors and the RF targets the
``rfnoise_*`` ones, as in the JAX package."""

import os

import numpy as np
import torch

from bayhunter_tpu_torch import Targets
from bayhunter_tpu_torch.sampler.chain import Sampler, make_config
from bayhunter_tpu_torch.sampler.evaluator import build_evaluator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, 'tests', 'fixtures')

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


def build_config(name, device, iters=2000, nl=21, dtype=torch.float32,
                 use_batch_swd=True):
    """(sampler, evaluator) of the configuration ``name`` of CONFIGS, its
    chains at ``dtype``, on the batch path or (``use_batch_swd`` False,
    which float64 needs) the per-chain ring path."""
    ip = initparams(iters)
    joint = joint_target(CONFIGS[name], flsph=int(name in SPHERICAL))
    cfg = make_config(PRIORS, ip, [t.noiseref for t in joint.targets],
                      nl=nl, dtype=dtype)
    ev = build_evaluator(joint, PRIORS, ip, nl, device, dtype,
                         use_batch_swd)
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


def tutorial_targets(positive_errors=False):
    """(joint target, std of the drawn SWD noise) of the reference
    tutorial (``tutorial/tutorialhunt.py:32-40, 72-75``): the fixtures'
    Rayleigh phase velocities and P-RF plus the port's ``SynthObs``
    noise, seeded as the JAX module is (``RandomState(333)``): SWD
    sigma 0.012 uncorrelated, RF sigma 0.005 with Gaussian correlation
    0.98.  The SWD target carries the drawn noise as its ``yerr``, as the
    tutorial does (not all positive: the uncorrelated law), or with
    ``positive_errors`` |noise| + 0.006 (the scaled-error law)."""
    from bayhunter_tpu_torch import synthobs
    synthobs.rstate = np.random.RandomState(333)
    xsw, ysw = np.loadtxt(os.path.join(FIXTURES, 'st3_rdispph.dat')).T
    xrf, yrf = np.loadtxt(os.path.join(FIXTURES, 'st3_prf.dat')).T
    sw_err = synthobs.SynthObs.compute_expnoise(ysw, corr=0.0, sigma=0.012)
    rf_err = synthobs.SynthObs.compute_gaussnoise(yrf, corr=0.98,
                                                  sigma=0.005)
    sw = Targets.RayleighDispersionPhase(
        xsw, ysw + sw_err,
        yerr=np.abs(sw_err) + 0.006 if positive_errors else sw_err)
    prf = Targets.PReceiverFunction(xrf, yrf + rf_err)
    prf.moddata.plugin.set_modelparams(gauss=1., water=0.01, p=6.4)
    return Targets.JointTarget([sw, prf]), float(np.std(sw_err))


def tutorial_params():
    """(priors, initparams) of the reference tutorial:
    ``tutorial/config.ini`` with ``tutorial/tutorialhunt.py:65-84``'s
    updates."""
    from bayhunter_tpu_torch import config
    priors, ip = config.load_params(os.path.join(ROOT, 'tutorial',
                                                 'config.ini'))
    priors.update({'mohoest': None, 'rfnoise_corr': 0.98,
                   'swdnoise_corr': 0.})
    ip.update({'nchains': 21, 'iter_burnin': 2048 * 16,
               'iter_main': 2048 * 8,
               'propdist': (0.025, 0.025, 0.015, 0.005, 0.005),
               'gauss_dof_correction': True})
    return priors, ip


# parallel tempering as docs/parameters.md:50-53 names it
TEMPERING = {'ntemps': 4, 'tmax': 1000.0, 'swap_every': 1,
             'adapt_ladder': True}
TEMPERED_CHAINS = 2560        # posterior chains; x ntemps on the device
TEMPERED_ITERS = (1024, 1024)  # burn-in, main
# snapshots per phase: thin = 1024 / 128 = 8 is a cycle's length or
# more, so that the sweeps run
TEMPERED_MAXMODELS = 128


def build_tempered():
    """(targets, priors, initparams) of ``tempered_tutorial`` for
    ``MCMC_Optimizer``: the tutorial with ``TEMPERING``,
    ``TEMPERED_CHAINS`` posterior chains, ``TEMPERED_ITERS`` and
    ``TEMPERED_MAXMODELS``.  The caller adds ``savepath``."""
    targets, _ = tutorial_targets()
    priors, ip = tutorial_params()
    ip.update(TEMPERING, nchains=TEMPERED_CHAINS,
              iter_burnin=TEMPERED_ITERS[0], iter_main=TEMPERED_ITERS[1],
              maxmodels=TEMPERED_MAXMODELS)
    return targets, priors, ip


# the tomography configuration: BASELINE.json configs[4] at the sizes of
# tests/test_tomo.py's two truth families
TOMO_CELLS = 1000
TOMO_CHAINS_PER_CELL = 100
TOMO_PERIODS = np.linspace(2, 40, 12)
TOMO_TRUTHS = (dict(h=np.array([10., 0.]), vs=np.array([3.4, 4.6])),
               dict(h=np.array([30., 0.]), vs=np.array([2.6, 4.2])))
TOMO_SIGMA = 0.005
TOMO_DATA_SEED = 0            # the noise draws of tomo_data
TOMO_RANDOM_SEED = 5          # the inversion's
TOMO_PRIORS = {'swdnoise_corr': 0.0, 'swdnoise_sigma': (1e-4, 0.05)}
# tests/test_tomo.py's initparams at 8x its 400 + 200 iterations: those
# recover the truths under its narrow priors (1-6 layers, vp/vs fixed),
# not under defaults.ini's (1-20 layers, vs 1-5, vp/vs inverted), where
# the thin/fast cells' median at 5 km still read 2.65 km/s after 600
# iterations on the card and 3.19-3.36 after 2,400 on the CPU (PERF.md)
TOMO_INITPARAMS = {'iter_burnin': 3200, 'iter_main': 1600,
                   'propdist': (0.03, 0.03, 0.015, 0.005, 0.005),
                   'acceptance': (40, 45), 'thickmin': 0.1}


def tomo_data(ncells=TOMO_CELLS, seed=TOMO_DATA_SEED, device=None):
    """(periods, Y) of ``tomo_1000x100``: cell k holds the Rayleigh phase
    velocities of truth family k % 2 (``TOMO_TRUTHS``, vp/vs 1.73, the
    port's ``swd.surfdisp_batch``) plus its own noise draw (sigma
    ``TOMO_SIGMA``, one ``RandomState(seed)`` stream over the cells in
    order)."""
    from bayhunter_tpu_torch.ops import swd
    h = np.array([t['h'] for t in TOMO_TRUTHS])
    vs = np.array([t['vs'] for t in TOMO_TRUTHS])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    c, err = swd.surfdisp_batch(h, vp, vs, rho, TOMO_PERIODS, iwave=2,
                                igr=0, device=device)
    if bool(err.any()):
        raise RuntimeError('a tomography truth model has no root')
    c = c.cpu().numpy().astype(float)
    rs = np.random.RandomState(seed)
    Y = np.stack([c[k % 2] + TOMO_SIGMA * rs.normal(size=TOMO_PERIODS.size)
                  for k in range(ncells)])
    return TOMO_PERIODS, Y


def build_tomo(device=None, devices=None):
    """The ``parallel.TomoInversion`` of ``tomo_1000x100`` on ``device``
    or split over ``devices`` (``TomoInversion``'s rules): ``defaults.ini``
    priors (layers 1-20, so 21 slots) with ``TOMO_PRIORS`` and
    ``TOMO_INITPARAMS``, ``TOMO_CHAINS_PER_CELL`` chains for each cell of
    :func:`tomo_data` (made on the first card)."""
    from bayhunter_tpu_torch.parallel.tomo import TomoInversion
    x, Y = tomo_data(device=device)
    return TomoInversion(x, Y, ref='rdispph',
                         chains_per_cell=TOMO_CHAINS_PER_CELL,
                         priors=dict(TOMO_PRIORS),
                         initparams=dict(TOMO_INITPARAMS),
                         random_seed=TOMO_RANDOM_SEED, device=device,
                         devices=devices)
