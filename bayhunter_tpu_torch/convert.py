"""Chain states to and from numpy.

Carries the fields of the JAX package's ``ChainState``
(``bayhunter_tpu/sampler/chain.py:51``) — vs, z, n, vpvs, noise, logL,
misfits, propdist, the accepted/proposed/fwdfail counters, iiter, the
forward cache, beta, the tomography ``cell`` and the tempering swap
counters — as numpy arrays into a
:class:`~bayhunter_tpu_torch.sampler.chain.ChainState` on a device and
back.  The JAX PRNG ``key`` is not carried: the port draws its randoms
from its own ``torch.Generator``.  A per-chain field given as a scalar
(the JAX ``ChainState`` defaults of ``cell`` and the swap counters) is
broadcast over the chains.  The float fields and the cache travel at
float32 or float64 (a float64 JAX state into a float64 port state,
whose run takes the per-chain ring path).
"""

import numpy as np
import torch

from bayhunter_tpu_torch.sampler.chain import ChainState

FLOAT_FIELDS = ('vs', 'z', 'vpvs', 'noise', 'logL', 'misfits', 'propdist',
                'beta')
INT_FIELDS = ('n', 'accepted', 'proposed', 'fwdfail', 'iiter', 'cell',
              'swap_accepted', 'swap_proposed')


def state_from_numpy(fields, device, dtype=torch.float32):
    """``fields``: a mapping (or object with attributes) holding the
    arrays named in FLOAT_FIELDS, INT_FIELDS and ``cache`` (a tuple per
    target of (y, roots, slopes)); the float fields and the cache become
    ``dtype`` tensors (float32 or float64)."""
    def get(name):
        return fields[name] if isinstance(fields, dict) \
            else getattr(fields, name)

    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def real(x):
        return torch.tensor(np.asarray(x, np_dtype), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    nchains = np.shape(get('n'))

    def per_chain(x):
        x = np.asarray(x)
        return np.broadcast_to(x, nchains) if x.ndim == 0 else x

    kw = {k: real(per_chain(get(k))) for k in FLOAT_FIELDS}
    kw.update({k: i32(per_chain(get(k))) for k in INT_FIELDS})
    kw['cache'] = tuple(tuple(real(a) for a in entry)
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
