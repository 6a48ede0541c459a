"""Batched inversions of many datasets: ``TomoInversion``
(``parallel/tomo.py``), imported on first use; and the chain axis split
over several devices (``parallel/mesh.py``, the counterpart of
``bayhunter_tpu/parallel/mesh.py``), which ``MCMC_Optimizer`` and
``TomoInversion`` run through ``devices=``."""

import importlib

from bayhunter_tpu_torch.parallel.mesh import (chain_sharding,  # noqa: F401
                                               shard_states)


def __getattr__(name):
    if name == 'TomoInversion':
        return importlib.import_module(
            'bayhunter_tpu_torch.parallel.tomo').TomoInversion
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
