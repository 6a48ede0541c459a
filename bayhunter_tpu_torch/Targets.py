"""Observed-data targets (numpy only).

Mirrors ``bayhunter_tpu/Targets.py`` (``ObservedData``, the six
concrete target classes and ``JointTarget``) without the forward
plugins: the port evaluates targets on the device through
``sampler/evaluator.py``, so a target here carries only its data and
the forward-model parameters its plugin would derive.

  * SWD targets: ``mode`` (1 = fundamental) and ``flsph`` (0 = flat
    earth), the defaults of ``bayhunter_tpu/forward/swd_plugin.py``.
  * RF targets: fsamp, tshft and nsamp = 2^ceil(log2(2 ndata)) from
    the observed time axis, gauss = 1, p = 6.4 s/deg and ``nsv``
    (near-surface S velocity, None = top layer), as derived in
    ``bayhunter_tpu/forward/rf_plugin.py:37-55``.
"""

import numpy as np

SWD_REFS = {'rdispph': (2, 0), 'ldispph': (1, 0),
            'rdispgr': (2, 1), 'ldispgr': (1, 1)}


class ObservedData(object):
    """Observed x/y(/yerr); a missing or non-positive yerr becomes NaN
    (``bayhunter_tpu/Targets.py:20-30``)."""

    def __init__(self, x, y, yerr=None):
        self.x = np.asarray(x, float)
        self.y = np.asarray(y, float)
        if (yerr is None or np.any(np.asarray(yerr) <= 0.)
                or np.any(np.isnan(yerr))):
            self.yerr = np.ones(self.x.size) * np.nan
        else:
            self.yerr = np.asarray(yerr, float)


def rf_obsparams(obsx):
    """(fsamp, tshft, nsamp) from an RF time axis
    (``forward/rf_plugin.py:44-55``)."""
    obsx = np.asarray(obsx, float)
    deltas = np.round(obsx[1:] - obsx[:-1], 4)
    if np.unique(deltas).size != 1:
        raise ValueError('RF sampling rate must be constant')
    fsamp = 1.0 / float(deltas[0])
    tshft = -float(obsx[0])
    nsamp = int(2 ** np.ceil(np.log2(obsx.size * 2)))
    return fsamp, tshft, nsamp


class SingleTarget(object):
    """One dataset and its forward-model parameters."""

    noiseref = None

    def __init__(self, x, y, ref, yerr=None):
        self.ref = ref
        self.obsdata = ObservedData(x, y, yerr)
        if ref in SWD_REFS:
            self.iwave, self.igr = SWD_REFS[ref]
            self.modelparams = {'mode': 1, 'flsph': 0}
        else:
            self.fsamp, self.tshft, self.nsamp = rf_obsparams(x)
            self.modelparams = {'wtype': 'P' if ref == 'prf' else 'SV',
                                'gauss': 1.0, 'p': 6.4, 'nsv': None}

    def set_modelparams(self, **mparams):
        self.modelparams.update(mparams)


class RayleighDispersionPhase(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'rdispph', yerr=yerr)


class RayleighDispersionGroup(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'rdispgr', yerr=yerr)


class LoveDispersionPhase(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'ldispph', yerr=yerr)


class LoveDispersionGroup(SingleTarget):
    noiseref = 'swd'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'ldispgr', yerr=yerr)


class PReceiverFunction(SingleTarget):
    noiseref = 'rf'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'prf', yerr=yerr)


class SReceiverFunction(SingleTarget):
    noiseref = 'rf'

    def __init__(self, x, y, yerr=None):
        SingleTarget.__init__(self, x, y, 'srf', yerr=yerr)


class JointTarget(object):
    """The list of targets one inversion fits jointly."""

    def __init__(self, targets):
        self.targets = targets
        self.ntargets = len(targets)
