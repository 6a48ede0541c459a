"""Receiver-function synthesis: Mueller (1985) reflectivity on packed
per-chain operands, deconvolution and the inverse transform.

Mirrors ``bayhunter_tpu/ops/rf.py`` and the pair arithmetic of
``bayhunter_tpu/ops/pallas_rf.py``:

  * complex values as explicit (re, im) tensor pairs and 2x2 complex
    matrices as 4-tuples of pairs (``_cmul`` ... ``_m4inv_of_eye_minus``,
    ``_csqrt``, ``_csqrt_conj_real``, ``_csqrt_plain_real``), formula
    for formula, since their branch cuts decide the sign of the RF;
  * the welded-interface R/T tables ``interface_coeffs``, the free
    surface ``free_surface`` and displacement matrix ``displacement``
    (``pallas_rf.py:155-264``);
  * ``flatten_model_T``: rfmini earth flattening (R = 6371 km);
  * ``transmission_response``: the uniform-Q (Qp 500, Qs 225, reference
    frequency 1 Hz) response (``rf.py:326`` with the shared 1/u^2 phase
    factor of ``pallas_rf.py:354-380``) on the model kernel's packed
    operands, P or SV incidence — the plain twin of kernel K3
    (``ops/resp.py``);
  * ``transmission_response_q``: the same with per-layer Qp/Qs planes
    and any reference frequency (``pallas_rf.py:382-388``, ``:804-811``)
    — the plain twin of kernel K3r;
  * ``deconvolve`` (``rf.py:512``, the SV swap included), the Gauss
    cutoff ``gauss_cut`` and the folded cos/sin inverse-DFT tables
    (``rf.py:666-711``);
  * ``synrf_batch`` and ``synrf``: the public batched RF forward of
    (C, NL) models with scalar or per-layer Q (``rf.py:602-715``) on
    kernels K6 and K3 or K3r.
"""

import numpy as np
import torch

EARTH_R = 6371.0          # rfmini's radius (not the SWD solver's 6370)
DEG_PER_KM = 0.00899
P_WAVE, SV_WAVE = 0, 1    # incidence of the RF's wave
# K3's uniform Q and reference frequency (csrc/resp.cu holds the same
# constants)
QP_UNIFORM, QS_UNIFORM = 500.0, 225.0
FREF = 1.0


def wave_index(wave_type):
    """``wave_type`` as the kernels take it, 0 (P) or 1 (SV)."""
    if wave_type not in (P_WAVE, SV_WAVE):
        raise ValueError('wave_type %r is neither P (0) nor SV (1)'
                         % (wave_type,))
    return int(wave_type)


# ----------------------------------------------------------------------
# complex pairs
# ----------------------------------------------------------------------

def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _cscale(s, a):
    return (s * a[0], s * a[1])


def _cinv(a):
    d = a[0] * a[0] + a[1] * a[1]
    return (a[0] / d, -a[1] / d)


def _cdiv(a, b):
    return _cmul(a, _cinv(b))


def _real(x):
    return (x, torch.zeros_like(x))


def _csqrt(a):
    """Principal square root of an (re, im) pair."""
    r = torch.sqrt(a[0] * a[0] + a[1] * a[1])
    re = torch.sqrt(torch.clamp(0.5 * (r + a[0]), min=0.0))
    im_mag = torch.sqrt(torch.clamp(0.5 * (r - a[0]), min=0.0))
    return (re, torch.where(a[1] < 0.0, -im_mag, im_mag))


def _cexp(a):
    m = torch.exp(a[0])
    return (m * torch.cos(a[1]), m * torch.sin(a[1]))


def _csqrt_conj_real(x):
    """conj(sqrt(complex(x))) for real x (interface coefficients)."""
    return (torch.sqrt(torch.clamp(x, min=0.0)),
            -torch.sqrt(torch.clamp(-x, min=0.0)))


def _csqrt_plain_real(x):
    return (torch.sqrt(torch.clamp(x, min=0.0)),
            torch.sqrt(torch.clamp(-x, min=0.0)))


def _m4mul(A, B):
    a11, a12, a21, a22 = A
    b11, b12, b21, b22 = B
    return (_cadd(_cmul(a11, b11), _cmul(a12, b21)),
            _cadd(_cmul(a11, b12), _cmul(a12, b22)),
            _cadd(_cmul(a21, b11), _cmul(a22, b21)),
            _cadd(_cmul(a21, b12), _cmul(a22, b22)))


def _m4inv_of_eye_minus(K):
    """inv(I - K) of a 2x2 complex K."""
    k11, k12, k21, k22 = K
    m11 = (1.0 - k11[0], -k11[1])
    m12 = (-k12[0], -k12[1])
    m21 = (-k21[0], -k21[1])
    m22 = (1.0 - k22[0], -k22[1])
    idet = _cinv(_csub(_cmul(m11, m22), _cmul(m12, m21)))
    return (_cmul(m22, idet), _cmul((-m12[0], -m12[1]), idet),
            _cmul((-m21[0], -m21[1]), idet), _cmul(m11, idet))


# ----------------------------------------------------------------------
# interface and surface coefficients (real elastic velocities)
# ----------------------------------------------------------------------

def interface_coeffs(p, vp1, vs1, rho1, vp2, vs2, rho2):
    """P-SV R/T matrices (rd, td, ru, tu) of a welded interface, each a
    4-tuple (11, 12, 21, 22) of (re, im) pairs (greens.cpp:19-85)."""
    mue1 = rho1 * vs1 * vs1
    mue2 = rho2 * vs2 * vs2
    c = 2.0 * (mue1 - mue2)
    u2 = p * p
    cu2 = c * u2
    a1 = _csqrt_conj_real(1.0 / (vp1 * vp1) - u2)
    a2 = _csqrt_conj_real(1.0 / (vp2 * vp2) - u2)
    b1 = _csqrt_conj_real(1.0 / (vs1 * vs1) - u2)
    b2 = _csqrt_conj_real(1.0 / (vs2 * vs2) - u2)
    t1 = cu2 - rho1 + rho2
    t2 = cu2 - rho1
    t3 = cu2 + rho2
    t4 = _csub(_cscale(t3, a1), _cscale(t2, a2))
    a1b1 = _cmul(a1, b1)
    a2b2 = _cmul(a2, b2)
    a1b2 = _cmul(a1, b2)
    a2b1 = _cmul(a2, b1)
    abab = _cmul(a1b1, a2b2)
    tb = _csub(_cscale(t3, b1), _cscale(t2, b2))
    rr = rho1 * rho2

    def table(d1, d2, rho_i, aa, bb, cross, mix_a, mix_b, rss_sign):
        t5 = _cinv(_cadd(d1, d2))
        t7 = _cscale(2.0 * rho_i, t5)
        rpp = _cmul(_csub(d2, d1), t5)
        core = _cmul(t5, cross)
        a_core = _cmul(aa, core)
        b_core = _cmul(bb, core)
        tpp = _cmul(aa, _cmul(t7, tb))
        tps = _cmul(aa, _cmul(t7, _cadd(_real(t1), _cscale(c, mix_a))))
        rss = _cmul(_csub(_csub(d2, d1),
                          _cscale(rss_sign * 2.0 * rho1 * rho2,
                                  _csub(a1b2, a2b1))), t5)
        tss = _cmul(bb, _cmul(t7, t4))
        tsp = _cmul(bb, _cmul(t7, _cadd(_real(t1), _cscale(c, mix_b))))
        return rpp, a_core, b_core, tpp, tps, rss, tss, tsp

    d1d = _cadd(_cadd(_real(t1 * t1 * u2), _cscale(t2 * t2, a2b2)),
                _cscale(rr, a2b1))
    d2d = _cadd(_cadd(_cscale(c * c * u2, abab), _cscale(t3 * t3, a1b1)),
                _cscale(rr, a1b2))
    cross_d = _cadd(_real(t1 * t3), _cscale(c * t2, a2b2))
    rpp, a_core, b_core, tpp, tps, rss, tss, tsp = table(
        d1d, d2d, rho1, a1, b1, cross_d, a2b1, a1b2, 1.0)
    rd = (rpp, _cscale(2.0 * p, b_core), _cscale(-2.0 * p, a_core), rss)
    td = (tpp, _cscale(p, tsp), _cscale(-p, tps), tss)

    d1u = _cadd(_cadd(_real(t1 * t1 * u2), _cscale(t3 * t3, a1b1)),
                _cscale(rr, a1b2))
    d2u = _cadd(_cadd(_cscale(c * c * u2, abab), _cscale(t2 * t2, a2b2)),
                _cscale(rr, a2b1))
    cross_u = _cadd(_real(t1 * t2), _cscale(c * t3, a1b1))
    rpp, a_core, b_core, tpp, tps, rss, tss, tsp = table(
        d1u, d2u, rho2, a2, b2, cross_u, a1b2, a2b1, -1.0)
    ru = (rpp, _cscale(-2.0 * p, b_core), _cscale(2.0 * p, a_core), rss)
    tu = (tpp, _cscale(p, tsp), _cscale(-p, tps), tss)
    return rd, td, ru, tu


def free_surface(p, vp, vs):
    """Free-surface P-SV reflection for upgoing waves (plain sqrt
    branch; greens.cpp:87-112)."""
    u2 = p * p
    a = _csqrt_plain_real(1.0 / (vp * vp) - u2)
    b = _csqrt_plain_real(1.0 / (vs * vs) - u2)
    t1 = 2.0 * vs * vs
    t2 = t1 * u2 - 1.0
    ab = _cscale(t1 * t1 * u2, _cmul(a, b))
    d = _cadd(_real(t2 * t2), ab)
    t3 = _cdiv(_real(2.0 * t1 * p * t2), d)
    rpp = _cdiv(_csub(ab, _real(t2 * t2)), d)
    rsp = _cscale(-1.0, _cmul(b, t3))
    rps = _cmul(a, t3)
    return (rpp, rsp, rps, rpp)


def displacement(p, vp, vs):
    """Free-surface displacement matrix (Mueller eq. 89)."""
    vs2 = vs * vs
    p2 = p * p
    x = 1.0 - 2.0 * vs2 * p2
    a1 = _csqrt_conj_real(1.0 / (vp * vp) - p2)
    b1 = _csqrt_conj_real(1.0 / vs2 - p2)
    ab = _cmul(a1, b1)
    q = _cinv(_cadd(_real(x * x), _cscale(4.0 * vs2 * vs2 * p2, ab)))
    qpab = _cmul(q, _cscale(p, ab))
    return (_cscale(2.0 * vs2, qpab), _cscale(x, _cmul(q, b1)),
            _cscale(x, _cmul(q, a1)), _cscale(-2.0 * vs2, qpab))


def flatten_model_T(h, vp, vs, rho):
    """rfmini earth flattening on (NL, C) layer planes: z -> R ln(R /
    (R - z)) at layer tops, v R/r, rho r/R (model.cpp:223-251)."""
    from bayhunter_tpu_torch.ops.voronoi import running_sum
    z_top = torch.cat([torch.zeros_like(h[:1]), running_sum(h)[:-1]],
                      dim=0)
    z_bot = z_top + h
    r = torch.full_like(h, EARTH_R)      # tensor / tensor: IEEE division
    q_top = r / (r - z_top)
    zf_top = EARTH_R * torch.log(q_top)
    zf_bot = EARTH_R * torch.log(r / (r - z_bot))
    return zf_bot - zf_top, vp * q_top, vs * q_top, rho / q_top


# ----------------------------------------------------------------------
# packed operands (rows of the model kernel's RF pack, (rows, C))
# ----------------------------------------------------------------------

def pack_offsets(nl):
    """Named row offsets of the per-chain RF pack of an NL-slot model:
    flattened h, vp and vs planes (NL rows each), slowness, direct-
    arrival time t0, displacement matrix and free-surface reflection (8
    rows each: re, im of entries 11, 12, 21, 22) and the skip depth,
    the last named row; ``rows`` is the pack's height, padded with zero
    rows to a multiple of 8.

    The one definition of the layout: the plain twins index the pack
    with it, and the wrappers pass it to both kernels
    (``csrc/pack.cuh``)."""
    off = dict(h=0, vp=nl, vs=2 * nl, p=3 * nl, t0=3 * nl + 1,
               hmat=3 * nl + 2, nt=3 * nl + 10, depth=3 * nl + 18)
    off['rows'] = -(-(off['depth'] + 1) // 8) * 8
    return off


def _pairs4(rows):
    """8 (C,) rows -> a 4-tuple of (re, im) pairs."""
    return tuple((rows[2 * m], rows[2 * m + 1]) for m in range(4))


def frequency_axis(nfreq_lanes, nsamp, fsamp, device, fref=FREF,
                   dtype=torch.float32):
    """(w, lgw) of the first ``nfreq_lanes`` frequencies, with the
    log-frequency term ln(w / wref) of Mueller eq. 132 at the
    reference frequency ``fref`` (Hz)."""
    jf = torch.arange(nfreq_lanes, device=device).clamp(
        max=nsamp // 2).to(dtype)
    w = jf * (2.0 * np.pi * fsamp / nsamp)
    wref = torch.tensor(2.0 * np.pi * fref, dtype=dtype, device=device)
    lgw = torch.where(jf > 0, torch.log(torch.clamp(w, min=1e-30) / wref),
                      torch.zeros_like(w))
    return w, lgw


def _inv_u2(lgw, q):
    """1/u(w)^2 of the uniform-Q complex velocity factor
    u = 1 + lgw/(pi Q) + i/(2Q)."""
    qf = torch.tensor(q, dtype=lgw.dtype, device=lgw.device)
    pi = torch.tensor(np.pi, dtype=lgw.dtype, device=lgw.device)
    u = (1.0 + lgw / (pi * qf), torch.full_like(lgw, 0.5) / qf)
    return _cinv(_cmul(u, u))


def _phase_of(x, w, h_l):
    """exp(-i w h qc) of the vertical slowness qc = sqrt(x)."""
    qc = _csqrt(x)
    return _cexp((w * h_l * qc[1], -w * h_l * qc[0]))


def _transmit(coefs, pack, w, phase_at, depth, wave_type):
    """The Mueller recursion shared by both responses: layer 0 (free
    surface on top) always runs, layers 1..``depth`` (C, 1) follow,
    deeper slots are identities and are skipped per chain;
    ``phase_at(i)`` gives layer i's (e1, e2).  Returns the (cz, cr)
    planes of incidence ``wave_type``."""
    nl = coefs.shape[0] // 32 + 1
    off = pack_offsets(nl)

    def row(k):
        return pack[k][:, None]                            # (C, 1)

    t0 = row(off['t0'])
    hmat = _pairs4([row(off['hmat'] + k) for k in range(8)])
    nt_surf = _pairs4([row(off['nt'] + k) for k in range(8)])

    def layer_parts(i):
        base = i * 32
        mats = tuple(_pairs4([coefs[base + m * 8 + k][:, None]
                              for k in range(8)]) for m in range(4))
        return (mats,) + tuple(phase_at(i))

    def sandwich(nt, e1, e2):
        e12 = _cmul(e1, e2)
        return (_cmul(nt[0], _cmul(e1, e1)), _cmul(nt[1], e12),
                _cmul(nt[2], e12), _cmul(nt[3], _cmul(e2, e2)))

    def columns(e1, e2, q_):
        return (_cmul(e1, q_[0]), _cmul(e1, q_[1]),
                _cmul(e2, q_[2]), _cmul(e2, q_[3]))

    (rd_n, td_i, ru_n, tu_n), e1, e2 = layer_parts(0)
    nb = sandwich(nt_surf, e1, e2)
    q_ = _m4mul(_m4inv_of_eye_minus(_m4mul(rd_n, nb)), tu_n)
    g = columns(e1, e2, q_)
    x = _m4mul(nb, q_)
    ru, td_prev = ru_n, td_i
    for i in range(1, nl - 1):
        (rd_n, td_i, ru_n, tu_n), e1, e2 = layer_parts(i)
        nt = tuple(_cadd(a, b) for a, b in zip(ru, _m4mul(td_prev, x)))
        nb = sandwich(nt, e1, e2)
        q_ = _m4mul(_m4inv_of_eye_minus(_m4mul(rd_n, nb)), tu_n)
        new = (_m4mul(nb, q_), _m4mul(g, columns(e1, e2, q_)), ru_n,
               td_i)
        on = depth >= i

        def sel(a, b):
            return tuple(tuple(torch.where(on, ua, ub)
                               for ua, ub in zip(pa, pb))
                         for pa, pb in zip(a, b))
        x, g, ru, td_prev = (sel(a, b) for a, b in
                             zip(new, (x, g, ru, td_prev)))

    # column wave_type of 2 hmat g: rows 0 (R) and 1 (Z)
    t_full = _m4mul(hmat, g)
    cr = _cscale(2.0, t_full[0 + wave_type])
    cz = _cscale(2.0, t_full[2 + wave_type])
    wt0 = w * t0
    qq = (torch.cos(wt0), torch.sin(wt0))
    cz = _cmul(cz, qq)
    cr = _cmul(cr, qq)
    return cz[0], cz[1], cr[0], cr[1]


def transmission_response(coefs, pack, nfreq_lanes, nsamp, fsamp,
                          wave_type=P_WAVE):
    """(cz, cr) responses for incidence ``wave_type`` under uniform Q
    (Qp 500, Qs 225, 1 Hz reference) as four (C, F) planes (cz re,
    cz im, cr re, cr im) for the first F = ``nfreq_lanes``
    frequencies — the plain twin of kernel K3.

    ``coefs`` ((NL-1)*32, C) interface tables (row l*32 + m*8 + e*2 +
    c); ``pack`` (rows, C) per-chain operands (:func:`pack_offsets`)."""
    nl = coefs.shape[0] // 32 + 1
    off = pack_offsets(nl)
    w, lgw = frequency_axis(nfreq_lanes, nsamp, fsamp, coefs.device,
                            dtype=coefs.dtype)
    w = w[None, :]
    iu2_p = tuple(x[None, :] for x in _inv_u2(lgw, QP_UNIFORM))
    iu2_s = tuple(x[None, :] for x in _inv_u2(lgw, QS_UNIFORM))
    p = pack[off['p']][:, None]

    def phase(v, h_l, iu2):
        r = 1.0 / (v * v)
        return _phase_of((iu2[0] * r - p * p, iu2[1] * r), w, h_l)

    def phase_at(i):
        h_l = pack[off['h'] + i][:, None]
        return (phase(pack[off['vp'] + i][:, None], h_l, iu2_p),
                phase(pack[off['vs'] + i][:, None], h_l, iu2_s))

    return _transmit(coefs, pack, w, phase_at,
                     pack[off['depth']][:, None], wave_type)


def q_depth(depth, qp, qs):
    """(C,) skip depths raised to the deepest slot whose lower
    interface has a Qp or Qs contrast (``pallas_rf.py:804-811``);
    ``depth`` the pack's row, ``qp``/``qs`` (NL, C) planes."""
    nl = qp.shape[0]
    idx = torch.arange(nl - 1, device=qp.device, dtype=depth.dtype)[:, None]
    contrast = (qp[:-1] != qp[1:]) | (qs[:-1] != qs[1:])
    deepest = torch.amax(torch.where(contrast, idx, torch.zeros_like(idx)),
                         dim=0)
    return torch.maximum(depth, deepest)


def transmission_response_q(coefs, pack, qp, qs, nfreq_lanes, nsamp, fsamp,
                            wave_type=P_WAVE, fref=FREF):
    """:func:`transmission_response` with per-layer quality factors —
    the plain twin of kernel K3r.  ``qp``, ``qs`` (NL, C) planes;
    ``fref`` the reference frequency (Hz) of the anelastic dispersion.
    Each layer's phase uses its complex velocity
    vc = v (1 + ln(w/wref)/(pi Q)) + i v/(2Q) (``pallas_rf.py:382-388``),
    and the skip depth counts Q contrasts (:func:`q_depth`)."""
    nl = coefs.shape[0] // 32 + 1
    off = pack_offsets(nl)
    w, lgw = frequency_axis(nfreq_lanes, nsamp, fsamp, coefs.device, fref,
                            dtype=coefs.dtype)
    w, lgw = w[None, :], lgw[None, :]
    p = pack[off['p']][:, None]
    pi = torch.tensor(np.pi, dtype=coefs.dtype, device=coefs.device)

    def phase(v, q, h_l):
        piq = pi * q
        vc = (v * (1.0 + lgw / piq), v * (torch.full_like(q, 0.5) / q))
        iv2 = _cinv(_cmul(vc, vc))
        return _phase_of((iv2[0] - p * p, iv2[1]), w, h_l)

    def phase_at(i):
        h_l = pack[off['h'] + i][:, None]
        return (phase(pack[off['vp'] + i][:, None], qp[i][:, None], h_l),
                phase(pack[off['vs'] + i][:, None], qs[i][:, None], h_l))

    depth = q_depth(pack[off['depth']], qp, qs)[:, None]
    return _transmit(coefs, pack, w, phase_at, depth, wave_type)


# ----------------------------------------------------------------------
# deconvolution and inverse transform
# ----------------------------------------------------------------------

def gauss_cut(nsamp, fsamp, gauss_a):
    """Frequency lanes kept by the Gauss low-pass cutoff w <= 6a."""
    nfreq = nsamp // 2 + 1
    dw = 2.0 * np.pi * fsamp / nsamp
    return min(nfreq, int(np.ceil(6.0 * float(gauss_a) / dw)) + 1)


def gauss_shift_coeffs(nfreq, nsamp, fsamp, tshift, gauss_a):
    """Per-frequency Gauss low-pass and time-shift factor (numpy)."""
    dw = 2.0 * np.pi * fsamp / nsamp
    w = dw * np.arange(nfreq)
    wa = np.minimum(w / gauss_a, 50.0)
    return (np.sqrt(np.pi) * fsamp / gauss_a
            * np.exp(-0.25 * wa * wa - 1j * w * tshift))


def dft_tables(cut, nsamp, fsamp, tshift, gauss_a, device):
    """Inverse real DFT over the first ``cut`` bins with the Gauss
    low-pass and time shift folded in: rf = Re(crf) @ cos_q +
    Im(crf) @ sin_q."""
    t = np.arange(nsamp)
    ang = 2.0 * np.pi * np.outer(np.arange(cut), t) / nsamp
    scale = np.full((cut, 1), 2.0 / nsamp)
    scale[0, 0] = 1.0 / nsamp
    cos_t = np.cos(ang) * scale
    sin_t = np.sin(ang) * (-scale)
    cq = gauss_shift_coeffs(cut, nsamp, fsamp, tshift, gauss_a)
    rq, iq = np.real(cq)[:, None], np.imag(cq)[:, None]
    return (torch.tensor(rq * cos_t + iq * sin_t, dtype=torch.float32,
                         device=device),
            torch.tensor(rq * sin_t - iq * cos_t, dtype=torch.float32,
                         device=device))


def rotate(czr, czi, crr, cri, p, vp_top, vs_top, wave_type=P_WAVE):
    """Z/R -> P/SV rotation with the near-surface velocities
    (greens.cpp:324-341); for SV incidence the rotated P and SV traces
    swap roles (greens.cpp:369-373).  ``p``, ``vp_top``, ``vs_top``:
    (C,).  Returns (zr, zi, rr, ri): the (re, im) planes of the divisor
    (Z, or for SV the rotated R) and of the dividend."""
    p, vp0, vs0 = p[:, None], vp_top[:, None], vs_top[:, None]
    fa = 1.0 / (vp0 * vp0) - p * p
    fb = 1.0 / (vs0 * vs0) - p * p
    a = torch.sqrt(torch.where(fa > 1e-30, fa, torch.full_like(fa, 1e-30)))
    b = torch.sqrt(torch.where(fb > 1e-30, fb, torch.full_like(fb, 1e-30)))
    m11 = -(2.0 * vs0 * vs0 * p * p - 1.0) / (vp0 * a)
    m12 = 2.0 * p * vs0 * vs0 / vp0
    m21 = -2.0 * p * vs0
    m22 = (1.0 - 2.0 * vs0 * vs0 * p * p) / (vs0 * b)
    do = (vs0 > 0.01) & (torch.abs(p) > 0.0001)
    zr, zi = (torch.where(do, cz_ * m11 + cr_ * m12, cz_)
              for cz_, cr_ in ((czr, crr), (czi, cri)))
    rr, ri = (torch.where(do, cz_ * m21 + cr_ * m22, cr_)
              for cz_, cr_ in ((czr, crr), (czi, cri)))
    if wave_type == SV_WAVE:
        return rr, ri, zr, zi
    return zr, zi, rr, ri


def divide(zr, zi, rr, ri):
    """The spectral division cr conj(cz) / |cz|^2 of rotated planes
    (greens.cpp:343-398; the waterlevel is not applied, as in the
    reference): the (re, im) planes of the RF spectrum."""
    denom = zr * zr + zi * zi
    return (rr * zr + ri * zi) / denom, (ri * zr - rr * zi) / denom


def deconvolve(czr, czi, crr, cri, p, vp_top, vs_top, wave_type=P_WAVE):
    """:func:`rotate`, then :func:`divide`: the (re, im) planes of the
    RF spectrum."""
    return divide(*rotate(czr, czi, crr, cri, p, vp_top, vs_top, wave_type))


def inverse_transform(fr, fi, nsamp, fsamp, tshift, gauss_a, dft=None):
    """RF time series (C, nsamp) of the deconvolved spectrum's (re, im)
    planes: the folded tables ``dft`` (:func:`dft_tables`) over the
    Gauss-cut lanes, or without them the Gauss/shift factor and
    ``irfft`` (the lanes beyond the planes' width taken as zero)."""
    if dft is not None:
        return fr @ dft[0] + fi @ dft[1]
    cdt = torch.complex128 if fr.dtype == torch.float64 else torch.complex64
    cq = torch.tensor(gauss_shift_coeffs(fr.shape[-1], nsamp, fsamp, tshift,
                                         gauss_a), dtype=cdt, device=fr.device)
    return torch.fft.irfft(torch.complex(fr, fi) * cq, nsamp, dim=-1)


def receiver_function(response, pack, nl, nsamp, fsamp, tshift, gauss_a,
                      dft=None, wave_type=P_WAVE):
    """RF time series (C, nsamp) from the response planes of
    :func:`transmission_response` and the (rows, C) pack of an NL-slot
    model: rotation with the pack's surface velocities and spectral
    division (:func:`deconvolve`), then :func:`inverse_transform`."""
    vp_top, vs_top = surface_velocities(pack, nl)
    fr, fi = deconvolve(*response, pack[pack_offsets(nl)['p']], vp_top,
                        vs_top, wave_type)
    return inverse_transform(fr, fi, nsamp, fsamp, tshift, gauss_a, dft)


def surface_velocities(pack, nl):
    """(vp_top, vs_top) of the Z/R rotation from the pack's surface rows
    (the flattened surface row equals the unflattened one, q_top(0) =
    1): nsv = vs0 and vp_top from its Poisson ratio (wrap.cpp:73-74)."""
    off = pack_offsets(nl)
    vp0, vs0 = pack[off['vp']], pack[off['vs']]
    vpvs0 = vp0 / vs0
    poisson = (2.0 - vpvs0 * vpvs0) / (2.0 - 2.0 * vpvs0 * vpvs0)
    return vs0 * torch.sqrt((1.0 - poisson) / (0.5 - poisson)), vs0


# ----------------------------------------------------------------------
# the public batched forward
# ----------------------------------------------------------------------

def _on_device(x, dev, shape=None):
    """``x`` (array, tensor or scalar) as a float32 tensor on ``dev``,
    broadcast to ``shape`` when given."""
    t = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return t if shape is None else t.expand(shape).contiguous()


def synrf_batch(h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp, fsamp,
                tshift, nsv, poisson, wave_type=P_WAVE, fref=FREF,
                flattening=True, device=None):
    """Receiver functions (C, nsamp) float32 of C layered models.

    ``h``, ``vp``, ``vs``, ``rho``: (C, NL) padded, unflattened layer
    arrays (halfspace last, zero-thickness padding); ``qp``, ``qs``:
    (C, NL) quality factors or scalars; ``p_sdeg`` slowness (s/deg);
    ``gauss_a`` the Gauss low-pass parameter; ``nsamp``, ``fsamp``,
    ``tshift`` the time axis; ``nsv``, ``poisson``: per chain (or
    scalar) near-surface S velocity and Poisson ratio of the Z/R
    rotation; ``wave_type`` P_WAVE or SV_WAVE; ``fref`` the reference
    frequency (Hz) of the anelastic dispersion.

    The models run as (NL, C) planes through K6 (flattening, interface
    tables, per-chain scalars), then K3r — or K3, which holds the
    default Qp 500, Qs 225 at 1 Hz, for exactly those scalars — over
    the Gauss-cut frequencies, then the deconvolution and the folded
    inverse DFT, as ``bayhunter_tpu/ops/rf.py`` ``synrf_batch`` does.
    Arrays and scalars go to ``device`` (default: CUDA; tensors stay
    on their own device unless ``device`` is given); CPU tensors run
    the kernels' plain twins.  ``flattening=False`` is not ported."""
    rotated, series = _rotated_spectra(
        h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp, fsamp, tshift, nsv,
        poisson, wave_type, fref, flattening, device)
    return series(*divide(*rotated))


def _rotated_spectra(h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp, fsamp,
                     tshift, nsv, poisson, wave_type, fref, flattening,
                     device):
    """:func:`synrf_batch` up to the spectral division: the rotated
    (zr, zi, rr, ri) planes (:func:`rotate`) and the function that turns
    a spectrum's (re, im) planes into time series under the Gauss
    low-pass and time shift."""
    from bayhunter_tpu_torch.ops import prep, resp

    if not flattening:
        raise NotImplementedError('synrf_batch without earth flattening '
                                  'is not ported yet')
    if device is not None:
        dev = torch.device(device)
    else:
        dev = h.device if torch.is_tensor(h) else torch.device('cuda')
    h_t, vp_t, vs_t, rho_t = (_on_device(x, dev).T.contiguous()
                              for x in (h, vp, vs, rho))
    nl, C = h_t.shape
    p_skm = float(p_sdeg) * DEG_PER_KM
    coefs, pack = prep.rf_operands(h_t, vp_t, vs_t, rho_t, p_skm, wave_type)
    cut = gauss_cut(nsamp, fsamp, gauss_a)
    scalar_q = isinstance(qp, (int, float)) and isinstance(qs, (int, float))
    if scalar_q and (float(qp), float(qs), float(fref)) == (
            QP_UNIFORM, QS_UNIFORM, FREF):
        response = resp.resp(coefs, pack, cut, nsamp, fsamp, wave_type)
    else:
        qp_t, qs_t = (_on_device(q, dev, (nl, C)) if isinstance(q, (int,
                                                                    float))
                      else _on_device(q, dev).T.contiguous()
                      for q in (qp, qs))
        response = resp.resp_q(coefs, pack, qp_t, qs_t, cut, nsamp, fsamp,
                               wave_type, fref)
    nsv_c, poisson_c = (_on_device(x, dev, (C,)) for x in (nsv, poisson))
    vp_top = nsv_c * torch.sqrt((1.0 - poisson_c) / (0.5 - poisson_c))
    rotated = rotate(*response, pack[pack_offsets(nl)['p']], vp_top, nsv_c,
                     wave_type)
    dft = (dft_tables(cut, nsamp, fsamp, tshift, gauss_a, dev)
           if cut < nsamp // 2 + 1 else None)

    def series(re, im):
        return inverse_transform(re, im, nsamp, fsamp, tshift, gauss_a, dft)

    return rotated, series


def synrf(h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp, fsamp, tshift,
          nsv, poisson, wave_type=P_WAVE, fref=FREF, flattening=True,
          device=None):
    """(fz, fr, rf), each (nsamp,), of one model of (NL,) layer arrays,
    as the JAX package's ``synrf`` returns them: the RF of
    :func:`synrf_batch` with C = 1 (``qp``, ``qs`` (NL,) or scalars),
    and the rotated Z and R traces it deconvolves under the same Gauss
    low-pass and time shift (for SV incidence the two swap roles, as
    in the JAX package)."""
    def one(x):
        return x if isinstance(x, (int, float)) else (
            x[None] if torch.is_tensor(x) else np.asarray(x)[None])
    rotated, series = _rotated_spectra(
        one(h), one(vp), one(vs), one(rho), one(qp), one(qs), p_sdeg,
        gauss_a, nsamp, fsamp, tshift, nsv, poisson, wave_type, fref,
        flattening, device)
    return tuple(series(*planes)[0] for planes in (
        rotated[:2], rotated[2:], divide(*rotated)))
