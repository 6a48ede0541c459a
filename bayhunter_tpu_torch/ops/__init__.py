"""Forward solvers, likelihood laws and the hand-written CUDA kernels
(``prep``: K1 model operands, ``walk``: K2 warm root walker, ``resp``:
K3 RF reflectivity response) with their plain PyTorch twins."""

import copy
import importlib

# every kernel wrapper: module -> its wrapper functions, each counting
# its launches in attributes that end in ``launches``
WRAPPERS = {'prep': ('model_operands', 'rf_operands'),
            'walk': ('warm_roots_walk',),
            'resp': ('resp', 'resp_q'),
            'swd': ('secular4', 'secular1')}


def _counters():
    """(wrapper key, wrapper function) of every kernel wrapper."""
    for mod, names in WRAPPERS.items():
        m = importlib.import_module('bayhunter_tpu_torch.ops.' + mod)
        for name in names:
            yield '%s.%s' % (mod, name), getattr(m, name)


def _zero(v):
    return [_zero(x) for x in v] if isinstance(v, list) else 0


def reset_launch_counts():
    """Set every kernel wrapper's launch counters in this process to
    0."""
    for _, fn in _counters():
        for k, v in list(vars(fn).items()):
            if k.endswith('launches'):
                setattr(fn, k, _zero(v))


def launch_counts():
    """Every kernel wrapper's launch counters in this process, as
    ``{'prep.model_operands': {'launches': n, 'sph_launches': m, ...},
    ...}`` (a copy): what each worker of a split run reports when it
    closes."""
    return {key: {k: copy.deepcopy(v) for k, v in vars(fn).items()
                  if k.endswith('launches')}
            for key, fn in _counters()}
