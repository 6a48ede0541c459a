"""Forward-model plugins: host-facing wrappers around the batched
solvers in ``ops/``, duck-type compatible with the reference plugin
protocol ``run_model(h, vp, vs, rho, **kw) -> (x, y)`` +
``set_modelparams(**kw)`` (reference: src/Targets.py:46-49).  Mirrors
``bayhunter_tpu/forward/``."""

from bayhunter_tpu_torch.forward.swd_plugin import SurfDisp  # noqa: F401
from bayhunter_tpu_torch.forward.rf_plugin import SynRF  # noqa: F401

# reference plugin class name alias for drop-in use
RFminiModRF = SynRF
