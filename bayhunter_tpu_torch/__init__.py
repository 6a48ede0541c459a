"""bayhunter_tpu_torch — the transdimensional McMC inversion of
receiver functions and surface-wave dispersion in PyTorch, with the
hot-path kernels written by hand in CUDA C++ for Hopper (sm_90a).

The JAX package ``bayhunter_tpu`` is the reference; this package keeps
its module layout so that every function has a findable counterpart
(each module's docstring names the JAX file it mirrors).

Device and dtype policy:

  * every function takes its device from the tensors it is given, or
    from an explicit ``device`` argument — nothing is moved implicitly;
  * the sampler state and every solver operand are float32 (``DTYPE``,
    the default) or, for a run given ``dtype=torch.float64``, float64:
    float32 runs take the batch path (K1, K2, K3 at the Gauss-cut
    lanes), float64 runs the per-chain ring path (K4/K5, K6, K3 at all
    lanes, their double instances), as the JAX package picks its paths;
    CPU callers may pass float64 to the plain functions for golden
    checks;
  * each CUDA kernel has a plain PyTorch twin in the same module; a
    kernel wrapper runs the twin only for tensors on the CPU and
    launches the kernel (or raises) for CUDA tensors.

Importing the package needs neither jax, triton, matplotlib nor a CUDA
toolchain: the kernels are compiled with ``nvcc`` at their first launch
(``ops/_ext.py``).  The reference's public names (``_PARITY_EXPORTS``,
as the JAX package's ``__init__`` lists them) are imported on first
use: ``MCMC_Optimizer`` (``optimizer.py``), the entry point of an
inversion, ``Targets``, ``SynthObs``, ``utils``, ``diagnostics``,
``Model`` and ``ModelMatrix`` (``models.py``), ``SingleChain``
(``sampler/chain.py``), ``PlotFromStorage`` (``plotting.py``, the
post-processing) and ``BayWatcher`` (``baywatch.py``, the live
monitor); matplotlib and zmq are imported only by the functions that
draw or open a socket.
The subpackages ``parallel`` (``parallel.TomoInversion``, tomography-scale
batched inversions) and ``sampler`` (``sampler.tempering``, parallel
tempering) are imported on first use as well.
"""

import importlib

import torch

DTYPE = torch.float32       # the default floating type of a run

# name -> (module, attribute); attribute None: the module itself
_PARITY_EXPORTS = {
    'Targets': ('bayhunter_tpu_torch.Targets', None),
    'SynthObs': ('bayhunter_tpu_torch.synthobs', 'SynthObs'),
    'MCMC_Optimizer': ('bayhunter_tpu_torch.optimizer', 'MCMC_Optimizer'),
    'utils': ('bayhunter_tpu_torch.utils', None),
    'diagnostics': ('bayhunter_tpu_torch.diagnostics', None),
    'Model': ('bayhunter_tpu_torch.models', 'Model'),
    'ModelMatrix': ('bayhunter_tpu_torch.models', 'ModelMatrix'),
    'SingleChain': ('bayhunter_tpu_torch.sampler.chain', 'SingleChain'),
    'PlotFromStorage': ('bayhunter_tpu_torch.plotting', 'PlotFromStorage'),
    'BayWatcher': ('bayhunter_tpu_torch.baywatch', 'BayWatcher'),
}
# subpackages imported on first attribute access
_SUBPACKAGES = ('parallel', 'sampler')


def __getattr__(name):
    if name in _PARITY_EXPORTS:
        modname, attr = _PARITY_EXPORTS[name]
        mod = importlib.import_module(modname)
        return mod if attr is None else getattr(mod, attr)
    if name in _SUBPACKAGES:
        return importlib.import_module('%s.%s' % (__name__, name))
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
