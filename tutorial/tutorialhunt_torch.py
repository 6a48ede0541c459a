"""End-to-end joint SWD + RF inversion of the synthetic station "st3"
with the PyTorch port: the steps of ``tutorialhunt.py`` through
``bayhunter_tpu_torch`` (load the config, add correlated noise with
known hyperparameters to the observed data, invert jointly, then
post-process and plot).

    python3 tutorial/create_testdata_torch.py
    python3 tutorial/tutorialhunt_torch.py [--device cpu] [--no-plots]

Runs the tutorial's own numbers (21 chains, 32,768 + 16,384 iterations)
on the GPU unless ``--device cpu`` is given, into tutorial/results_torch/
(the JAX script's tutorial/results/ stays untouched).  ``--no-plots``
(``plots=False``) skips the figures and their summary PDF, for a
machine without matplotlib; the default draws them and fails without
matplotlib.  ``main`` takes the run's size for shorter runs.
"""

import argparse
import logging
import os
import os.path as op
import sys

import numpy as np

sys.path.insert(0, op.join(op.dirname(op.abspath(__file__)), '..'))
from bayhunter_tpu_torch import (Targets, utils,  # noqa: E402
                                 MCMC_Optimizer, PlotFromStorage, synthobs)

HERE = op.dirname(op.abspath(__file__))
OBSERVED = op.join(HERE, 'observed')
RESULTS = op.join(HERE, 'results_torch')
# the injected noise: (corr, sigma) of the SWD (exponential law) and of
# the RF (Gaussian law), which the posterior must recover
NOISE = [0.0, 0.012, 0.98, 0.005]


def main(savepath=RESULTS, nchains=21, iter_burnin=2048 * 16,
         iter_main=2048 * 8, random_seed=None, device=None, plots=True,
         observed=OBSERVED):
    """The tutorial's inversion of the data in ``observed`` into
    ``savepath`` (its BayWatch config ``baywatch.pkl`` there too);
    returns (optimizer, PlotFromStorage of its files).  ``plots`` False
    skips ``save_plots`` and ``merge_pdfs``."""
    if plots:
        # the figures need matplotlib: fail here, not figure by figure
        import matplotlib  # noqa: F401
    priors, initparams = utils.load_params(op.join(HERE, 'config.ini'))

    xsw, _ysw = np.loadtxt(op.join(observed, 'st3_rdispph.dat')).T
    xrf, _yrf = np.loadtxt(op.join(observed, 'st3_prf.dat')).T

    # correlated noise with KNOWN (corr, sigma) per target, drawn from
    # the seeded noise generator of SynthObs
    synthobs.rstate = np.random.RandomState(333)
    ysw_err = synthobs.SynthObs.compute_expnoise(_ysw, corr=NOISE[0],
                                                 sigma=NOISE[1])
    ysw = _ysw + ysw_err
    yrf_err = synthobs.SynthObs.compute_gaussnoise(_yrf, corr=NOISE[2],
                                                   sigma=NOISE[3])
    yrf = _yrf + yrf_err

    # reference model for the plots and BayWatch
    dep, vs = np.loadtxt(op.join(observed, 'st3_mod.dat'),
                         usecols=[0, 2], skiprows=1).T
    pdep = np.concatenate((np.repeat(dep, 2)[1:], [150]))
    pvs = np.repeat(vs, 2)
    truenoise = np.concatenate(([NOISE[0]], [np.std(ysw_err)],
                                [NOISE[2]], [np.std(yrf_err)]))
    explike = synthobs.SynthObs.compute_explike(
        yobss=[ysw, yrf], ymods=[_ysw, _yrf], noise=truenoise,
        gauss=[False, True], rcond=initparams['rcond'])
    truemodel = {'model': (pdep, pvs), 'nlays': 3,
                 'noise': truenoise, 'explike': explike}
    print('true noise:', truenoise, ' expected logL:', explike)

    target1 = Targets.RayleighDispersionPhase(xsw, ysw, yerr=ysw_err)
    target2 = Targets.PReceiverFunction(xrf, yrf)
    target2.moddata.plugin.set_modelparams(gauss=1., water=0.01, p=6.4)
    targets = Targets.JointTarget(targets=[target1, target2])

    priors.update({'mohoest': None, 'rfnoise_corr': 0.98,
                   'swdnoise_corr': 0.})
    initparams.update({'nchains': nchains,
                       'iter_burnin': iter_burnin,
                       'iter_main': iter_main,
                       'propdist': (0.025, 0.025, 0.015, 0.005, 0.005),
                       # the exact truncated-subspace Gaussian law, as
                       # tutorialhunt.py recommends
                       'gauss_dof_correction': True,
                       'savepath': savepath})

    os.makedirs(savepath, exist_ok=True)
    utils.save_baywatch_config(targets, path=savepath, priors=priors,
                               initparams=initparams, refmodel=truemodel)
    optimizer = MCMC_Optimizer(targets, initparams=initparams,
                               priors=priors, random_seed=random_seed,
                               device=device)
    # baywatch=True streams over ZMQ; watch with
    # ``python -m bayhunter_tpu_torch.baywatch tutorial/results_torch``
    optimizer.mp_inversion(baywatch=True, dtsend=1)

    configfile = op.join(savepath, 'data',
                         '%s_config.pkl' % initparams['station'])
    obj = PlotFromStorage(configfile, device=device)
    obj.save_final_distribution(maxmodels=100000, dev=0.05)
    if plots:
        obj.save_plots(refmodel=truemodel)
        obj.merge_pdfs()
    return optimizer, obj


if __name__ == '__main__':
    formatter = ' %(processName)-12s: %(levelname)-8s |  %(message)s'
    logging.basicConfig(format=formatter, level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default=None)
    ap.add_argument('--no-plots', dest='plots', action='store_false')
    args = ap.parse_args()
    if args.plots:
        import matplotlib
        matplotlib.use('PDF')
    main(device=args.device, plots=args.plots)
