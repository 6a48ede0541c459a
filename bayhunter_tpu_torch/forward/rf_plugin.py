"""Receiver-function plugin (host API around ``ops/rf.py``).

Mirrors ``bayhunter_tpu/forward/rf_plugin.py``, the drop-in equivalent
of the reference's Cython wrapper ``RFminiModRF``
(src/rfmini_modrf.py:13-154): fsamp, tshift and nsamp from the observed
time axis, Qp = 500 / Qs = 225 by default, the rotation velocities from
the top layer or a fixed ``nsv``, and the synthetic RF trimmed to the
observed samples.  The model goes to ``rf.synrf`` with its own layers
(no fixed-width padding); the RF runs on CUDA (K6, then K3 for the
default Q or K3r for per-layer Q) unless the plugin is constructed or
called with ``device='cpu'``, which runs the kernels' plain twins.
The rfmini helpers ``coeff``/``coeffs`` are re-exported for API parity
(rfmini.pyx:252-331).
"""

import numpy as np

from bayhunter_tpu_torch.ops.rf import (synrf, coeff, coeffs,  # noqa: F401
                                        P_WAVE, SV_WAVE)


class SynRF(object):
    """Forward modeling of receiver functions (rfmini equivalent)."""

    def __init__(self, obsx, ref, device=None):
        self.ref = ref
        self.obsx = np.asarray(obsx, float)
        self.device = device
        self._init_obsparams()

        if self.ref in ['prf', 'seis']:
            self.modelparams = {'wtype': 'P'}
        elif self.ref in ['srf']:
            self.modelparams = {'wtype': 'SV'}
        else:
            self.modelparams = {'wtype': 'P'}

        self.modelparams.update({
            'gauss': 1.0,   # Gauss low-pass parameter a
            'p': 6.4,       # slowness in s/deg
            'water': 0.001,  # accepted for parity; not applied
            'nsv': None,    # near-surface S velocity for rotation
        })

    def _init_obsparams(self):
        """fsamp/tshft/nsamp from the observed time vector
        (reference: src/rfmini_modrf.py:41-62)."""
        deltas = np.round(self.obsx[1:] - self.obsx[:-1], 4)
        if np.unique(deltas).size != 1:
            raise ValueError("Target: %s. Sampling rate must be constant."
                             % self.ref)
        dt = float(deltas[0])
        self.fsamp = 1.0 / dt
        self.tshft = -self.obsx[0]
        ndata = self.obsx.size
        self.nsamp = int(2 ** np.ceil(np.log2(ndata * 2)))

    def set_modelparams(self, **mparams):
        self.modelparams.update(mparams)

    def write_startmodel(self, h, vp, vs, rho, modfile, **params):
        """ASCII model file writer (reference: src/rfmini_modrf.py:64-94):
        depth of each layer top, vp, vs, rho, qp, qs."""
        h = np.asarray(h, float)
        qp = np.asarray(params.get('qp', np.ones(h.size) * 500.))
        qs = np.asarray(params.get('qs', np.ones(h.size) * 225.))
        z = np.cumsum(h)
        z = np.concatenate(([0], z[:-1]))
        fmt = {'z': '%.2f', 'vp': '%.4f', 'vs': '%.4f', 'rho': '%.4f',
               'qp': '%.1f', 'qs': '%.1f'}
        cols = [('z', z), ('vp', vp), ('vs', vs), ('rho', rho),
                ('qp', qp), ('qs', qs)]
        cols = [(k, np.asarray(v, float)) for k, v in cols
                if v is not None]
        with open(modfile, 'w') as f:
            f.write('\t'.join(k for k, _ in cols) + '\n')
            line = '\t'.join(fmt[k] for k, _ in cols) + '\n'
            for i in range(z.size):
                f.write(line % tuple(v[i] for _, v in cols))

    def compute_rf(self, h, vp, vs, rho, device=None, **params):
        """Synthetic receiver function for one layered model
        (reference: src/rfmini_modrf.py:99-142)."""
        gauss = self.modelparams['gauss']
        p = self.modelparams['p']
        wtype = self.modelparams['wtype']
        nsv = self.modelparams['nsv']

        qp = params.get('qp', 500.)
        qs = params.get('qs', 225.)
        if not np.isscalar(qp):
            qp = np.asarray(qp, np.float32)
        if not np.isscalar(qs):
            qs = np.asarray(qs, np.float32)

        nsvp, nsvs = float(vp[0]), float(vs[0])
        vpvs = nsvp / nsvs
        poisson = (2 - vpvs ** 2) / (2 - 2 * vpvs ** 2)
        if nsv is None:
            nsv = nsvs

        time = np.arange(self.nsamp) / self.fsamp - self.tshft

        layers = [np.asarray(x, np.float32).reshape(-1)
                  for x in (h, vp, vs, rho)]
        layers[0] = layers[0].copy()
        layers[0][-1] = 0.0          # the halfspace slot
        if layers[0].size == 1:      # the kernels need two slots
            layers = [np.repeat(x, 2) for x in layers]
            qp, qs = (q if np.isscalar(q) else np.repeat(q, 2)
                      for q in (qp, qs))
        wave = P_WAVE if wtype == 'P' else SV_WAVE
        _, _, qrf = synrf(
            *layers, qp, qs, p, gauss, self.nsamp,
            self.fsamp, self.tshft, nsv, poisson, wave_type=wave,
            device=device if device is not None else self.device)

        qrfdata = qrf.cpu().numpy().astype(float)
        return time[:self.obsx.size], qrfdata[:self.obsx.size]

    def run_model(self, h, vp, vs, rho, device=None, **params):
        h = np.asarray(h, float)
        vp = np.asarray(vp, float)
        vs = np.asarray(vs, float)
        rho = np.asarray(rho, float)
        assert h.size == vp.size == vs.size == rho.size
        return self.compute_rf(h, vp, vs, rho, device=device, **params)
