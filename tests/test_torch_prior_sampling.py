"""The port's transdimensional sampler under a constant likelihood
samples the prior (CPU): the layer-count marginal of a long prior-only
run through ``dispatch_cycles`` is uniform over the prior's range, with
the counts, schedule and per-bin tolerance of the JAX package's own
test (``tests/test_sampler.py``
``test_prior_only_dispatch_cycles_uniform_layer_histogram``: 128
chains, 40 segments of 100 late iterations, the first 15 dropped, every
bin within 0.035 of uniform).  This holds the birth/death proposals and
the Bodin et al. (2012) acceptance terms, and K1's prior validity
(its plain twin on the CPU), free of any forward solver.
"""

import torch_threads  # noqa: F401  (one PyTorch thread a process)

from bayhunter_tpu_torch import gates

# tests/test_sampler.py's PRIORS, with its prior-only widths
# (gates.PRIOR_INITPARAMS: wide birth/death proposals, width adaptation
# disabled)
PRIORS = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 10),
          'vpvs': 1.73, 'mohoest': None, 'mantle': None,
          'swdnoise_corr': 0.0, 'swdnoise_sigma': (1e-5, 0.05),
          'rfnoise_corr': 0.92, 'rfnoise_sigma': (1e-5, 0.05)}
NL = 11


def test_prior_only_dispatch_cycles_uniform_layer_histogram():
    sp = gates.prior_sampler(PRIORS, 'cpu', ('swd',), nl=NL)
    r = gates.prior_histogram(sp, 128, seed=7, segments=40, drop=15)
    print(r)
    # every bin within 0.035 of uniform, every accepted model inside
    # the vs prior box (nucleus counts outside the prior raise)
    assert r['max_dev'] < 0.035, r['hist']
    assert PRIORS['vs'][0] <= r['vs_range'][0]
    assert r['vs_range'][1] <= PRIORS['vs'][1]
    assert r['ok']
