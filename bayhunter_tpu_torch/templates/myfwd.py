"""Template: a user-defined forward-model plugin.

The counterpart of ``templates/myfwd.py`` (the reference extension
point, templates/myfwd.py:13-53) for the PyTorch port.  To run inside
the sampler the plugin provides, beside the host protocol, a batched
forward in PyTorch:

  * ``run_model(h, vp, vs, rho, **kwargs) -> (x, y)`` — the host
    protocol that SynthObs and ``JointTarget.evaluate`` call
    (duck-typed as in the reference, src/Targets.py:75-82), on one
    model's unpadded layers; NaN-filled arrays on failure;
  * ``run_model_torch(h, vp, vs, rho) -> y`` — the sampler's forward
    (``sampler/evaluator.py``): (C, NL) padded layer tensors on the
    chains' device (halfspace last, zero-thickness padding, see
    ``ops/voronoi.py``), float32 in the sampler, and a (C, ndata)
    tensor out.  It runs once per model step for all chains, so it
    should be written in tensor operations.  Non-finite values in a
    chain's row mark its forward as failed (the sentinel likelihood,
    src/Targets.py:325-328).
"""

import numpy as np
import torch


class MyForwardModel(object):

    def __init__(self, obsx, ref):
        self.obsx = np.asarray(obsx)
        self.ref = ref
        self.modelparams = {}

    def set_modelparams(self, **mparams):
        self.modelparams.update(mparams)

    def run_model_torch(self, h, vp, vs, rho):
        """Batched device forward: (C, NL) padded layers -> (C, ndata)."""
        # --- replace with your physics ---
        return vs.mean(dim=-1, keepdim=True).expand(-1, self.obsx.size)

    def run_model(self, h, vp, vs, rho, **kwargs):
        """Host forward: one model's unpadded layers -> (x, y)."""
        layers = (torch.as_tensor(np.asarray(x, float))[None]
                  for x in (h, vp, vs, rho))
        y = self.run_model_torch(*layers)[0]
        return self.obsx, y.numpy()
