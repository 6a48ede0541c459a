"""Forward-model the tutorial's synthetic station "st3" (a 4-layer
crust) with the PyTorch port: ``create_testdata.py`` through
``bayhunter_tpu_torch``'s ``SynthObs`` (surface-wave dispersion through
the K4/K5 cold search, receiver functions through K6 and K3).

    python3 tutorial/create_testdata_torch.py [OUTDIR] [--device cpu]

Writes st3_{rdispph,rdispgr,ldispph,ldispgr,prf,srf}.dat and
st3_mod.dat into OUTDIR (default: tutorial/observed/).  Runs on the GPU
unless ``--device cpu`` is given."""

import argparse
import os
import os.path as op
import sys

sys.path.insert(0, op.join(op.dirname(op.abspath(__file__)), '..'))
from bayhunter_tpu_torch import SynthObs  # noqa: E402

HERE = op.dirname(op.abspath(__file__))
OBSERVED = op.join(HERE, 'observed')

IDX = 3
H = [5, 23, 8, 0]
VS = [2.7, 3.6, 3.8, 4.4]
VPVS = 1.73


def main(path=OBSERVED, device=None):
    """Write the station's data and model files into ``path``; returns
    the data file pattern (``st3_%s.dat`` under ``path``)."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    datafile = op.join(path, 'st%d_%s.dat' % (IDX, '%s'))

    # surface-wave dispersion (all four target types)
    sw_x = np.linspace(1, 41, 21)
    swdata = SynthObs.return_swddata(H, VS, vpvs=VPVS, x=sw_x,
                                     device=device)
    SynthObs.save_data(swdata, outfile=datafile)

    # receiver functions (P and S)
    rfdata = SynthObs.return_rfdata(H, VS, vpvs=VPVS, x=None,
                                    pars={'p': 6.4}, device=device)
    SynthObs.save_data(rfdata, outfile=datafile)

    # velocity-depth model
    SynthObs.save_model(H, VS, vpvs=VPVS,
                        outfile=op.join(path, 'st%d_mod.dat' % IDX))
    print('wrote synthetic data for st%d to %s' % (IDX, path))
    return datafile


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('outdir', nargs='?', default=OBSERVED)
    ap.add_argument('--device', default=None)
    args = ap.parse_args()
    main(args.outdir, args.device)
