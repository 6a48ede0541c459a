// Rayleigh secular function of one (wavenumber, frequency) candidate:
// the Dunkin 5-vector compound-matrix recursion from the halfspace up
// with per-layer max-abs renormalisation, and the water-surface clause
// (bayhunter_tpu/ops/pallas_secular.py _dltar4_halfspace /
// _dltar4_layer_math, ops/pallas_walk.py secular; reference
// surfdisp96.f:773-1068).  Same operation order as the plain twin
// (bayhunter_tpu_torch/ops/walk.py secular_plain).
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

static __device__ __forceinline__ evec dltar4_halfspace(
        float wvno, float wvno2, float omega, float a_hs, float b_hs,
        float rho_hs) {
    float ra = vertical(wvno, omega / a_hs);
    float rb = vertical(wvno, omega / b_hs);
    float t_hs = b_hs / omega;
    float gammk = 2.0f * t_hs * t_hs;
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

static __device__ __forceinline__ evec dltar4_layer(
        const evec &e, float wvno, float wvno2, float omega, float d_l,
        float a_l, float b_l, float rho_l) {
    float xka = omega / a_l;
    float xkb = omega / b_l;
    float rai = vertical(wvno, xka);
    float rbi = vertical(wvno, xkb);
    float t_l = b_l / omega;
    float gammki = 2.0f * t_l * t_l;
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
