"""Estimate the receiver-function noise correlation r_RF from the Gauss
filter width used when computing the observed RFs, with the PyTorch
port: ``estimate_rRF.py`` through ``bayhunter_tpu_torch.utils``
(``rrf_estimate``, ``plot_rrf_estimate``; numpy, no device).

    python3 tutorial/estimate_rRF_torch.py [--draws 2000] [--figure FILE]

Reads observed/st3_prf.dat (``create_testdata_torch.py`` writes it) for
the RF time axis, prints the Gauss filter width fitted to each
candidate r_RF and, with ``--figure``, saves the figure (matplotlib)."""

import argparse
import os.path as op
import sys

import numpy as np

sys.path.insert(0, op.join(op.dirname(op.abspath(__file__)), '..'))
from bayhunter_tpu_torch import utils  # noqa: E402

HERE = op.dirname(op.abspath(__file__))
RRFS = [0.95, 0.96, 0.97, 0.98, 0.99]     # candidate correlations


def main(rffile=op.join(HERE, 'observed', 'st3_prf.dat'), draws=2000,
         rrfs=RRFS, figure=None):
    """(sorted r_RF candidates, fitted Gauss filter widths) of the RF
    time axis of ``rffile`` with ``draws`` noise realizations per
    candidate; with ``figure`` a file name, the figure saved there."""
    rfx = np.loadtxt(rffile, usecols=[0])
    pars = {'rfx': rfx,        # RF time axis (sets dt)
            'draws': draws,    # noise realizations per candidate
            'rrfs': list(rrfs)}
    rrfs, a_est = utils.rrf_estimate(pars=pars)
    for r, a in zip(rrfs, a_est):
        print('rfnoise_corr %.3f  <->  Gauss filter width a = %.3f'
              % (r, a))
    if figure:
        utils.plot_rrf_estimate(pars=pars).savefig(figure,
                                                   bbox_inches='tight')
    return rrfs, a_est


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--rffile', default=op.join(HERE, 'observed',
                                                'st3_prf.dat'))
    ap.add_argument('--draws', type=int, default=2000)
    ap.add_argument('--figure', default=None)
    args = ap.parse_args()
    main(args.rffile, args.draws, figure=args.figure)
