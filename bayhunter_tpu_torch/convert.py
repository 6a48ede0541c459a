"""Chain states to and from numpy.

Carries the fields of the JAX package's ``ChainState``
(``bayhunter_tpu/sampler/chain.py:51``) — vs, z, n, vpvs, noise, logL,
misfits, propdist, the accepted/proposed/fwdfail counters, iiter, the
forward cache and beta — as numpy arrays into a
:class:`~bayhunter_tpu_torch.sampler.chain.ChainState` on a device and
back.  The JAX PRNG ``key`` (and the tomography ``cell`` and
tempering-swap counters) are not carried: the port draws its randoms
from its own ``torch.Generator``.
"""

import numpy as np
import torch

from bayhunter_tpu_torch.sampler.chain import ChainState

FLOAT_FIELDS = ('vs', 'z', 'vpvs', 'noise', 'logL', 'misfits', 'propdist',
                'beta')
INT_FIELDS = ('n', 'accepted', 'proposed', 'fwdfail', 'iiter')


def state_from_numpy(fields, device):
    """``fields``: a mapping (or object with attributes) holding the
    arrays named in FLOAT_FIELDS, INT_FIELDS and ``cache`` (a tuple per
    target of (y, roots, slopes))."""
    def get(name):
        return fields[name] if isinstance(fields, dict) \
            else getattr(fields, name)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    kw = {k: f32(get(k)) for k in FLOAT_FIELDS}
    kw.update({k: i32(get(k)) for k in INT_FIELDS})
    kw['cache'] = tuple(tuple(f32(a) for a in entry)
                        for entry in get('cache'))
    return ChainState(**kw)


def state_to_numpy(state):
    """The state's fields as a dict of numpy arrays (cache as nested
    tuples)."""
    out = {k: getattr(state, k).cpu().numpy()
           for k in FLOAT_FIELDS + INT_FIELDS}
    out['cache'] = tuple(tuple(a.cpu().numpy() for a in entry)
                         for entry in state.cache)
    return out
