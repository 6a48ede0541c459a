"""Surface-wave dispersion plugin (host API around ``ops/swd.py``).

Mirrors ``bayhunter_tpu/forward/swd_plugin.py``, the drop-in equivalent
of the reference's f2py wrapper ``SurfDisp`` (src/surf96_modsw.py:13-126):
the same constructor, ``set_modelparams``, target-ref tags and
``run_model`` contract (``(nan, nan)`` on solver failure).  More than 60
periods are solved at 60 periods evenly spaced over the observed range
and interpolated to the observed ones, as the reference does
(src/surf96_modsw.py:35-43, 106-122).

The model goes to the solver with its own layers (the JAX plugin pads
every call to 100 slots to keep one XLA compilation; the kernels here
need no fixed width): the last slot is the halfspace, and a pure
halfspace gets one zero-thickness slot above it.  The solve runs on
CUDA (K4 or K5 for every secular evaluation of the cold search) unless
the plugin is constructed or called with ``device='cpu'``, which runs
the kernels' plain twins.
"""

import numpy as np

from bayhunter_tpu_torch.ops.swd import surfdisp


class SurfDisp(object):
    """Forward modeling of dispersion curves (surf96 equivalent)."""

    def __init__(self, obsx, ref, device=None):
        self.obsx = np.asarray(obsx, float)
        self.kmax = self.obsx.size
        self.ref = ref
        self.device = device

        self.modelparams = {
            'mode': 1,   # 1 fundamental, 2 first higher
            'flsph': 0,  # 0 flat earth, 1 spherical
        }
        self.wavetype, self.veltype = self.get_surftags(ref)

        if self.kmax > 60:
            self.obsx_int = np.linspace(self.obsx.min(), self.obsx.max(),
                                        60)

    def set_modelparams(self, **mparams):
        self.modelparams.update(mparams)

    def get_surftags(self, ref):
        """(iwave, igr) per target ref
        (reference: src/surf96_modsw.py:48-66)."""
        tags = {'rdispgr': (2, 1), 'ldispgr': (1, 1),
                'rdispph': (2, 0), 'ldispph': (1, 0)}
        if ref not in tags:
            raise ReferenceError(
                "Reference %s not available in SurfDisp. Available: "
                "rdispgr, ldispgr, rdispph, ldispph "
                "(r=rayleigh, l=love, gr=group, ph=phase)" % ref)
        return tags[ref]

    def get_modelvectors(self, h, vp, vs, rho):
        """(h, vp, vs, rho) as float32 arrays with the halfspace last and
        its thickness 0; a pure halfspace gets a zero-thickness slot
        above it (the solver needs two slots)."""
        out = [np.asarray(x, np.float32).reshape(-1)
               for x in (h, vp, vs, rho)]
        out[0] = out[0].copy()
        out[0][-1] = 0.0
        if out[0].size == 1:
            out = [np.repeat(x, 2) for x in out]
        return out

    def run_model(self, h, vp, vs, rho, device=None, **params):
        """Forward dispersion for one layered model; returns (x, y) or
        (nan, nan) on failure (reference: src/surf96_modsw.py:84-126)."""
        h4, vp4, vs4, rho4 = self.get_modelvectors(h, vp, vs, rho)

        if self.kmax > 60:
            pers = self.obsx_int
        else:
            pers = self.obsx

        cg, err = surfdisp(
            h4, vp4, vs4, rho4, pers, iwave=self.wavetype,
            mode=self.modelparams['mode'], igr=self.veltype,
            iflsph=self.modelparams['flsph'],
            device=device if device is not None else self.device)
        if bool(err):
            return np.nan, np.nan
        cg = cg.cpu().numpy().astype(float)
        if self.kmax > 60:
            return self.obsx, np.interp(self.obsx, pers, cg)
        return pers, cg
