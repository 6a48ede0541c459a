"""bayhunter_tpu_torch — the transdimensional McMC inversion of
receiver functions and surface-wave dispersion in PyTorch, with the
hot-path kernels written by hand in CUDA C++ for Hopper (sm_90a).

The JAX package ``bayhunter_tpu`` is the reference; this package keeps
its module layout so that every function has a findable counterpart
(each module's docstring names the JAX file it mirrors).

Device and dtype policy:

  * every function takes its device from the tensors it is given, or
    from an explicit ``device`` argument — nothing is moved implicitly;
  * the sampler state and every solver operand are float32
    (``DTYPE``); CPU callers may pass float64 to the plain functions
    for golden checks;
  * each CUDA kernel has a plain PyTorch twin in the same module; a
    kernel wrapper runs the twin only for tensors on the CPU and
    launches the kernel (or raises) for CUDA tensors.

Importing the package needs neither jax, triton nor a CUDA toolchain:
the kernels are compiled with ``nvcc`` at their first launch
(``ops/_ext.py``).
"""

import torch

DTYPE = torch.float32
