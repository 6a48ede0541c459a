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
// Shared by K2 (walk.cu, float) and K4/K5 (secular.cu, float and
// double): every function is a template on the scalar type T, its
// literals T(...) (each float literal equals the float it replaced).
// Same operation order as the plain twins
// (bayhunter_tpu_torch/ops/swd.py secular_plain).  Each layer update
// comes in two parts: the terms that do not depend on the candidate
// (*_invariants, love_*) and the update from them (*_at).
#pragma once

#include "real.cuh"

template <class T>
struct evec_t {
    T e1, e2, e3, e4, e5;
};
using evec = evec_t<float>;

template <class T>
struct varq {
    T cos_, w, x, ex;
};

template <class T>
static __device__ __forceinline__ T vertical(T wvno, T xk) {
    return msqrt((wvno + xk) * mabs(wvno - xk));
}

template <class T>
static __device__ __forceinline__ varq<T> var_quantities(T pq, T r, bool prop,
                                                         T dpth) {
    varq<T> v;
    bool rz = r == T(0);
    T r_safe = rz ? T(1) : r;
    if (prop) {
        T sin_p = msin(pq);
        v.w = rz ? dpth : sin_p / r_safe;
        v.x = -r * sin_p;
        v.cos_ = mcos(pq);
        v.ex = T(0);
    } else {
        T fac = pq < T(16) ? mexp(T(-2) * pq) : T(0);
        T sin_ev = T(0.5) * (T(1) - fac);
        v.cos_ = T(0.5) * (T(1) + fac);
        v.w = rz ? dpth : sin_ev / r_safe;
        v.x = r * sin_ev;
        v.ex = pq;
    }
    return v;
}

// The terms of a layer (or the halfspace) that depend on the frequency
// and the layer but not on the candidate wavenumber.  A caller that
// evaluates many candidates at one frequency computes them once; each
// is the very expression of the one-shot recursion, so the split
// changes no rounding.
template <class T>
struct dunkin_inv_t {
    T xka, xkb, gammk;
};
using dunkin_inv = dunkin_inv_t<float>;

template <class T>
static __device__ __forceinline__ dunkin_inv_t<T> dltar4_invariants(
        T omega, T a_l, T b_l) {
    dunkin_inv_t<T> v;
    v.xka = omega / a_l;
    v.xkb = omega / b_l;
    T t_l = b_l / omega;
    v.gammk = T(2) * t_l * t_l;
    return v;
}

template <class T>
static __device__ __forceinline__ evec_t<T> dltar4_halfspace_at(
        T wvno, T wvno2, const dunkin_inv_t<T> &v, T rho_hs) {
    T ra = vertical(wvno, v.xka);
    T rb = vertical(wvno, v.xkb);
    T gammk = v.gammk;
    T gam = gammk * wvno2;
    T gamm1 = gam - T(1);
    evec_t<T> e;
    e.e1 = rho_hs * rho_hs * (gamm1 * gamm1 - gam * gammk * ra * rb);
    e.e2 = -rho_hs * ra;
    e.e3 = rho_hs * (gamm1 - gammk * ra * rb);
    e.e4 = rho_hs * rb;
    e.e5 = wvno2 - ra * rb;
    return e;
}

// one Dunkin layer update from the layer's invariant terms
template <class T>
static __device__ __forceinline__ evec_t<T> dltar4_layer_at(
        const evec_t<T> &e, T wvno, T wvno2, T d_l, T rho_l, T xka, T xkb,
        T gammki) {
    T rai = vertical(wvno, xka);
    T rbi = vertical(wvno, xkb);
    T gami = gammki * wvno2;
    varq<T> P = var_quantities(rai * d_l, rai, wvno < xka, d_l);
    varq<T> S = var_quantities(rbi * d_l, rbi, wvno < xkb, d_l);
    T exa = P.ex + S.ex;
    T a0 = exa < T(60) ? mexp(-exa) : T(0);

    T cpcq = P.cos_ * S.cos_;
    T cpy = P.cos_ * S.w;
    T cpz = P.cos_ * S.x;
    T cqw = S.cos_ * P.w;
    T cqx = S.cos_ * P.x;
    T xy = P.x * S.w;
    T xz = P.x * S.x;
    T wy = P.w * S.w;
    T wz = P.w * S.x;

    T gamm1i = gami - T(1);
    T twgm1 = gami + gamm1i;
    T gmgmk = gami * gammki;
    T gmgm1 = gami * gamm1i;
    T gm1sq = gamm1i * gamm1i;
    T rho2 = rho_l * rho_l;
    T a0pq = a0 - cpcq;

    T ca11 = cpcq - T(2) * gmgm1 * a0pq - gmgmk * xz - wvno2 * gm1sq * wy;
    T ca12 = (wvno2 * cpy - cqx) / rho_l;
    T ca13 = -(twgm1 * a0pq + gammki * xz + wvno2 * gamm1i * wy) / rho_l;
    T ca14 = (cpz - wvno2 * cqw) / rho_l;
    T ca15 = -(T(2) * wvno2 * a0pq + xz + wvno2 * wvno2 * wy) / rho2;
    T ca21 = (gmgmk * cpz - gm1sq * cqw) * rho_l;
    T ca22 = cpcq;
    T ca23 = gammki * cpz - gamm1i * cqw;
    T ca24 = -wz;
    T ca25 = ca14;
    T ca41 = (gm1sq * cpy - gmgmk * cqx) * rho_l;
    T ca42 = -xy;
    T ca43 = gamm1i * cpy - gammki * cqx;
    T ca44 = ca22;
    T ca45 = ca12;
    T ca51 = -(T(2) * gmgmk * gm1sq * a0pq + gmgmk * gmgmk * xz
               + gm1sq * gm1sq * wy) * rho2;
    T ca52 = ca41;
    T ca53 = -(gammki * gamm1i * twgm1 * a0pq + gami * gammki * gammki * xz
               + gamm1i * gm1sq * wy) * rho_l;
    T ca54 = ca21;
    T ca55 = ca11;
    T tt = T(-2) * wvno2;
    T ca31 = tt * ca53;
    T ca32 = tt * ca43;
    T ca33 = a0 + T(2) * (cpcq - ca11);
    T ca34 = tt * ca23;
    T ca35 = tt * ca13;

    T n1 = e.e1 * ca11 + e.e2 * ca21 + e.e3 * ca31 + e.e4 * ca41 + e.e5 * ca51;
    T n2 = e.e1 * ca12 + e.e2 * ca22 + e.e3 * ca32 + e.e4 * ca42 + e.e5 * ca52;
    T n3 = e.e1 * ca13 + e.e2 * ca23 + e.e3 * ca33 + e.e4 * ca43 + e.e5 * ca53;
    T n4 = e.e1 * ca14 + e.e2 * ca24 + e.e3 * ca34 + e.e4 * ca44 + e.e5 * ca54;
    T n5 = e.e1 * ca15 + e.e2 * ca25 + e.e3 * ca35 + e.e4 * ca45 + e.e5 * ca55;

    T nrm = mmax(mmax(mabs(n1), mabs(n2)),
                 mmax(mmax(mabs(n3), mabs(n4)), mabs(n5)));
    if (nrm < T(1e-40)) nrm = T(1);
    T inv = T(1) / nrm;
    evec_t<T> out;
    out.e1 = n1 * inv;
    out.e2 = n2 * inv;
    out.e3 = n3 * inv;
    out.e4 = n4 * inv;
    out.e5 = n5 * inv;
    return out;
}

// Rayleigh's water-surface clause: the layer-0 P term closes the
// recursion that stopped below the water (xka0 = omega / a_0)
template <class T>
static __device__ __forceinline__ T water_close(const evec_t<T> &e, T wvno,
                                               T xka0, T d0, T rho0) {
    T ra0 = vertical(wvno, xka0);
    varq<T> w = var_quantities(ra0 * d0, ra0, wvno < xka0, d0);
    return w.cos_ * e.e1 - rho0 * w.w * e.e2;
}

template <class T>
struct evec2_t {
    T e1, e2;
};
using evec2 = evec2_t<float>;

// Love's halfspace start from its invariant terms xkb_hs = omega / b_hs
// and e2 = 1 / b_hs^2
template <class T>
static __device__ __forceinline__ evec2_t<T> dltar1_halfspace_at(
        T wvno, T xkb_hs, T rho_hs, T e2) {
    evec2_t<T> e;
    e.e1 = rho_hs * vertical(wvno, xkb_hs);
    e.e2 = e2;
    return e;
}

// Love's candidate-invariant layer terms: xkb depends on the frequency,
// b_safe and xmu on the layer alone
template <class T>
static __device__ __forceinline__ T love_b_safe(T b_l) {
    return b_l <= T(0) ? T(1) : b_l;
}

template <class T>
static __device__ __forceinline__ T love_xmu(T rho_l, T b_safe) {
    return rho_l * b_safe * b_safe;
}

template <class T>
static __device__ __forceinline__ evec2_t<T> dltar1_layer_at(
        const evec2_t<T> &e, T wvno, T d_l, T xkb, T xmu) {
    T rb = vertical(wvno, xkb);
    varq<T> S = var_quantities(rb * d_l, rb, wvno < xkb, d_l);
    T e10 = e.e1 * S.cos_ + e.e2 * xmu * S.x;
    T e20 = e.e1 * S.w / xmu + e.e2 * S.cos_;
    T nrm = mmax(mabs(e10), mabs(e20));
    if (nrm < T(1e-40)) nrm = T(1);
    evec2_t<T> out;
    out.e1 = e10 / nrm;
    out.e2 = e20 / nrm;
    return out;
}
