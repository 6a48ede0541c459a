// Secular (period-equation) functions of one (wavenumber, frequency)
// candidate, from the halfspace up with per-layer max-abs
// renormalisation (reference surfdisp96.f:710-1068):
//
//   * Rayleigh: the Dunkin 5-vector compound-matrix recursion and the
//     water-surface clause (bayhunter_tpu/ops/pallas_secular.py
//     _dltar4_halfspace / _dltar4_layer_math);
//   * Love: the Haskell SH 2-vector recursion (_dltar1_layer_math and
//     the halfspace start of _dltar1_kernel); a surface water layer is
//     skipped.
//
// Shared by K2 (walk.cu) and K4/K5 (secular.cu).  Same operation order
// as the plain twins (bayhunter_tpu_torch/ops/swd.py secular_plain).
// Each layer update comes in two parts: the terms that do not depend on
// the candidate (*_invariants, love_*) and the update from them
// (*_at); the one-shot functions chain the two.
#pragma once

struct evec {
    float e1, e2, e3, e4, e5;
};

struct varq {
    float cos_, w, x, ex;
};

static __device__ __forceinline__ float vertical(float wvno, float xk) {
    return sqrtf((wvno + xk) * fabsf(wvno - xk));
}

static __device__ __forceinline__ varq var_quantities(float pq, float r,
                                                      bool prop, float dpth) {
    varq v;
    bool rz = r == 0.0f;
    float r_safe = rz ? 1.0f : r;
    if (prop) {
        float sin_p = sinf(pq);
        v.w = rz ? dpth : sin_p / r_safe;
        v.x = -r * sin_p;
        v.cos_ = cosf(pq);
        v.ex = 0.0f;
    } else {
        float fac = pq < 16.0f ? expf(-2.0f * pq) : 0.0f;
        float sin_ev = 0.5f * (1.0f - fac);
        v.cos_ = 0.5f * (1.0f + fac);
        v.w = rz ? dpth : sin_ev / r_safe;
        v.x = r * sin_ev;
        v.ex = pq;
    }
    return v;
}

// The terms of a layer (or the halfspace) that depend on the frequency
// and the layer but not on the candidate wavenumber.  A caller that
// evaluates many candidates at one frequency (the walker K2) computes
// them once; each is the very expression of the one-shot path, so the
// split changes no rounding.
struct dunkin_inv {
    float xka, xkb, gammk;
};

static __device__ __forceinline__ dunkin_inv dltar4_invariants(
        float omega, float a_l, float b_l) {
    dunkin_inv v;
    v.xka = omega / a_l;
    v.xkb = omega / b_l;
    float t_l = b_l / omega;
    v.gammk = 2.0f * t_l * t_l;
    return v;
}

static __device__ __forceinline__ evec dltar4_halfspace_at(
        float wvno, float wvno2, const dunkin_inv &v, float rho_hs) {
    float ra = vertical(wvno, v.xka);
    float rb = vertical(wvno, v.xkb);
    float gammk = v.gammk;
    float gam = gammk * wvno2;
    float gamm1 = gam - 1.0f;
    evec e;
    e.e1 = rho_hs * rho_hs * (gamm1 * gamm1 - gam * gammk * ra * rb);
    e.e2 = -rho_hs * ra;
    e.e3 = rho_hs * (gamm1 - gammk * ra * rb);
    e.e4 = rho_hs * rb;
    e.e5 = wvno2 - ra * rb;
    return e;
}

static __device__ __forceinline__ evec dltar4_halfspace(
        float wvno, float wvno2, float omega, float a_hs, float b_hs,
        float rho_hs) {
    return dltar4_halfspace_at(wvno, wvno2,
                               dltar4_invariants(omega, a_hs, b_hs), rho_hs);
}

// one Dunkin layer update from the layer's invariant terms
static __device__ __forceinline__ evec dltar4_layer_at(
        const evec &e, float wvno, float wvno2, float d_l, float rho_l,
        float xka, float xkb, float gammki) {
    float rai = vertical(wvno, xka);
    float rbi = vertical(wvno, xkb);
    float gami = gammki * wvno2;
    varq P = var_quantities(rai * d_l, rai, wvno < xka, d_l);
    varq S = var_quantities(rbi * d_l, rbi, wvno < xkb, d_l);
    float exa = P.ex + S.ex;
    float a0 = exa < 60.0f ? expf(-exa) : 0.0f;

    float cpcq = P.cos_ * S.cos_;
    float cpy = P.cos_ * S.w;
    float cpz = P.cos_ * S.x;
    float cqw = S.cos_ * P.w;
    float cqx = S.cos_ * P.x;
    float xy = P.x * S.w;
    float xz = P.x * S.x;
    float wy = P.w * S.w;
    float wz = P.w * S.x;

    float gamm1i = gami - 1.0f;
    float twgm1 = gami + gamm1i;
    float gmgmk = gami * gammki;
    float gmgm1 = gami * gamm1i;
    float gm1sq = gamm1i * gamm1i;
    float rho2 = rho_l * rho_l;
    float a0pq = a0 - cpcq;

    float ca11 = cpcq - 2.0f * gmgm1 * a0pq - gmgmk * xz - wvno2 * gm1sq * wy;
    float ca12 = (wvno2 * cpy - cqx) / rho_l;
    float ca13 = -(twgm1 * a0pq + gammki * xz + wvno2 * gamm1i * wy) / rho_l;
    float ca14 = (cpz - wvno2 * cqw) / rho_l;
    float ca15 = -(2.0f * wvno2 * a0pq + xz + wvno2 * wvno2 * wy) / rho2;
    float ca21 = (gmgmk * cpz - gm1sq * cqw) * rho_l;
    float ca22 = cpcq;
    float ca23 = gammki * cpz - gamm1i * cqw;
    float ca24 = -wz;
    float ca25 = ca14;
    float ca41 = (gm1sq * cpy - gmgmk * cqx) * rho_l;
    float ca42 = -xy;
    float ca43 = gamm1i * cpy - gammki * cqx;
    float ca44 = ca22;
    float ca45 = ca12;
    float ca51 = -(2.0f * gmgmk * gm1sq * a0pq + gmgmk * gmgmk * xz
                   + gm1sq * gm1sq * wy) * rho2;
    float ca52 = ca41;
    float ca53 = -(gammki * gamm1i * twgm1 * a0pq + gami * gammki * gammki * xz
                   + gamm1i * gm1sq * wy) * rho_l;
    float ca54 = ca21;
    float ca55 = ca11;
    float tt = -2.0f * wvno2;
    float ca31 = tt * ca53;
    float ca32 = tt * ca43;
    float ca33 = a0 + 2.0f * (cpcq - ca11);
    float ca34 = tt * ca23;
    float ca35 = tt * ca13;

    float n1 = e.e1 * ca11 + e.e2 * ca21 + e.e3 * ca31 + e.e4 * ca41 + e.e5 * ca51;
    float n2 = e.e1 * ca12 + e.e2 * ca22 + e.e3 * ca32 + e.e4 * ca42 + e.e5 * ca52;
    float n3 = e.e1 * ca13 + e.e2 * ca23 + e.e3 * ca33 + e.e4 * ca43 + e.e5 * ca53;
    float n4 = e.e1 * ca14 + e.e2 * ca24 + e.e3 * ca34 + e.e4 * ca44 + e.e5 * ca54;
    float n5 = e.e1 * ca15 + e.e2 * ca25 + e.e3 * ca35 + e.e4 * ca45 + e.e5 * ca55;

    float nrm = fmaxf(fmaxf(fabsf(n1), fabsf(n2)),
                      fmaxf(fmaxf(fabsf(n3), fabsf(n4)), fabsf(n5)));
    if (nrm < 1e-40f) nrm = 1.0f;
    float inv = 1.0f / nrm;
    evec out;
    out.e1 = n1 * inv;
    out.e2 = n2 * inv;
    out.e3 = n3 * inv;
    out.e4 = n4 * inv;
    out.e5 = n5 * inv;
    return out;
}

static __device__ __forceinline__ evec dltar4_layer(
        const evec &e, float wvno, float wvno2, float omega, float d_l,
        float a_l, float b_l, float rho_l) {
    dunkin_inv v = dltar4_invariants(omega, a_l, b_l);
    return dltar4_layer_at(e, wvno, wvno2, d_l, rho_l, v.xka, v.xkb,
                           v.gammk);
}

// Rayleigh's water-surface clause: the layer-0 P term closes the
// recursion that stopped below the water (xka0 = omega / a_0)
static __device__ __forceinline__ float water_close(const evec &e,
                                                   float wvno, float xka0,
                                                   float d0, float rho0) {
    float ra0 = vertical(wvno, xka0);
    varq w = var_quantities(ra0 * d0, ra0, wvno < xka0, d0);
    return w.cos_ * e.e1 - rho0 * w.w * e.e2;
}

struct evec2 {
    float e1, e2;
};

// Love's halfspace start from its invariant terms xkb_hs = omega / b_hs
// and e2 = 1 / b_hs^2
static __device__ __forceinline__ evec2 dltar1_halfspace_at(
        float wvno, float xkb_hs, float rho_hs, float e2) {
    evec2 e;
    e.e1 = rho_hs * vertical(wvno, xkb_hs);
    e.e2 = e2;
    return e;
}

static __device__ __forceinline__ evec2 dltar1_halfspace(
        float wvno, float omega, float b_hs, float rho_hs) {
    return dltar1_halfspace_at(wvno, omega / b_hs, rho_hs,
                               1.0f / (b_hs * b_hs));
}

// Love's candidate-invariant layer terms: xkb depends on the frequency,
// b_safe and xmu on the layer alone
static __device__ __forceinline__ float love_b_safe(float b_l) {
    return b_l <= 0.0f ? 1.0f : b_l;
}

static __device__ __forceinline__ float love_xmu(float rho_l, float b_safe) {
    return rho_l * b_safe * b_safe;
}

static __device__ __forceinline__ evec2 dltar1_layer_at(
        const evec2 &e, float wvno, float d_l, float xkb, float xmu) {
    float rb = vertical(wvno, xkb);
    varq S = var_quantities(rb * d_l, rb, wvno < xkb, d_l);
    float e10 = e.e1 * S.cos_ + e.e2 * xmu * S.x;
    float e20 = e.e1 * S.w / xmu + e.e2 * S.cos_;
    float nrm = fmaxf(fabsf(e10), fabsf(e20));
    if (nrm < 1e-40f) nrm = 1.0f;
    evec2 out;
    out.e1 = e10 / nrm;
    out.e2 = e20 / nrm;
    return out;
}

static __device__ __forceinline__ evec2 dltar1_layer(
        const evec2 &e, float wvno, float omega, float d_l, float b_l,
        float rho_l) {
    float b_safe = love_b_safe(b_l);
    return dltar1_layer_at(e, wvno, d_l, omega / b_safe,
                           love_xmu(rho_l, b_safe));
}

// One chain's padded layer columns (halfspace in slot nl - 1): slot l
// of a property p is p[off + l * stride], so one struct serves the
// (NL, C) planes of the walker and the (C, NL) rows of K4/K5.  Slots
// above ``top`` (the deepest with thickness) are zero-thickness
// copies of the halfspace, identities up to a positive scale, and are
// not applied.
struct ChainLayers {
    const float *__restrict__ d;
    const float *__restrict__ a;   // unused by Love
    const float *__restrict__ b;
    const float *__restrict__ rho;
    size_t off;
    size_t stride;
    int nl;
    int top;
    bool water;

    __device__ float at(const float *__restrict__ p, int l) const {
        return __ldg(p + off + (size_t)l * stride);
    }

    // deepest slot 0..nl-2 with d > 0, -1 for a pure halfspace
    __device__ int deepest() const {
        for (int l = nl - 2; l >= 0; --l)
            if (at(d, l) > 0.0f) return l;
        return -1;
    }

    // IWAVE 1 = Love, 2 = Rayleigh (a template parameter, so that each
    // kernel holds one recursion); omega already clamped to >= 1e-4
    template <int IWAVE>
    __device__ float secular(float wvno, float omega) const {
        if constexpr (IWAVE == 1) {
            evec2 e = dltar1_halfspace(wvno, omega, at(b, nl - 1),
                                       at(rho, nl - 1));
            for (int l = top; l >= 0; --l) {
                if (l == 0 && water) break;
                e = dltar1_layer(e, wvno, omega, at(d, l), at(b, l),
                                 at(rho, l));
            }
            return e.e1;
        }
        float wvno2 = wvno * wvno;
        evec e = dltar4_halfspace(wvno, wvno2, omega, at(a, nl - 1),
                                  at(b, nl - 1), at(rho, nl - 1));
        for (int l = top; l >= 0; --l) {
            if (l == 0 && water) break;
            e = dltar4_layer(e, wvno, wvno2, omega, at(d, l), at(a, l),
                             at(b, l), at(rho, l));
        }
        return water ? water_close(e, wvno, omega / at(a, 0), at(d, 0),
                                   at(rho, 0))
                     : e.e1;
    }
};
