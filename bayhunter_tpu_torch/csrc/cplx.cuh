// Complex (re, im) pairs and 2x2 complex matrices, formula for formula
// as the (re, im) helpers of bayhunter_tpu/ops/pallas_rf.py (:73-148)
// and their plain twins in bayhunter_tpu_torch/ops/rf.py; templates on
// the scalar type T (float for K1, float and double for K3 and K6), their
// literals T(...) (each float literal equals the float it replaced).
// No library complex type is used: the square-root branch cuts below
// decide the sign of the receiver function and must match the twins.
#pragma once

#include "real.cuh"

template <class T>
struct cplx {
    T re, im;
};

// 2x2 complex matrix (m11, m12, m21, m22)
template <class T>
struct mat4 {
    cplx<T> a11, a12, a21, a22;
};

using cf = cplx<float>;
using m4 = mat4<float>;

template <class T>
static __device__ __forceinline__ cplx<T> cmk(T re, T im) {
    cplx<T> r;
    r.re = re;
    r.im = im;
    return r;
}

template <class T>
static __device__ __forceinline__ cplx<T> creal(T x) { return cmk(x, T(0)); }

template <class T>
static __device__ __forceinline__ cplx<T> cmul(cplx<T> a, cplx<T> b) {
    return cmk(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

template <class T>
static __device__ __forceinline__ cplx<T> cadd(cplx<T> a, cplx<T> b) {
    return cmk(a.re + b.re, a.im + b.im);
}

template <class T>
static __device__ __forceinline__ cplx<T> csub(cplx<T> a, cplx<T> b) {
    return cmk(a.re - b.re, a.im - b.im);
}

template <class T>
static __device__ __forceinline__ cplx<T> cscale(T s, cplx<T> a) {
    return cmk(s * a.re, s * a.im);
}

template <class T>
static __device__ __forceinline__ cplx<T> cneg(cplx<T> a) {
    return cmk(-a.re, -a.im);
}

template <class T>
static __device__ __forceinline__ cplx<T> cinv(cplx<T> a) {
    T d = a.re * a.re + a.im * a.im;
    return cmk(a.re / d, -a.im / d);
}

template <class T>
static __device__ __forceinline__ cplx<T> cdiv(cplx<T> a, cplx<T> b) {
    return cmul(a, cinv(b));
}

// principal square root
template <class T>
static __device__ __forceinline__ cplx<T> csqrt_pair(cplx<T> a) {
    T r = msqrt(a.re * a.re + a.im * a.im);
    T re = msqrt(mmax(T(0.5) * (r + a.re), T(0)));
    T im_mag = msqrt(mmax(T(0.5) * (r - a.re), T(0)));
    return cmk(re, a.im < T(0) ? -im_mag : im_mag);
}

template <class T>
static __device__ __forceinline__ cplx<T> cexp_pair(cplx<T> a) {
    T m = mexp(a.re);
    return cmk(m * mcos(a.im), m * msin(a.im));
}

// conj(sqrt(complex(x))) for real x (interface coefficients)
template <class T>
static __device__ __forceinline__ cplx<T> csqrt_conj_real(T x) {
    return cmk(msqrt(mmax(x, T(0))), -msqrt(mmax(-x, T(0))));
}

template <class T>
static __device__ __forceinline__ cplx<T> csqrt_plain_real(T x) {
    return cmk(msqrt(mmax(x, T(0))), msqrt(mmax(-x, T(0))));
}

template <class T>
static __device__ __forceinline__ mat4<T> m4mul(const mat4<T> &A,
                                                const mat4<T> &B) {
    mat4<T> r;
    r.a11 = cadd(cmul(A.a11, B.a11), cmul(A.a12, B.a21));
    r.a12 = cadd(cmul(A.a11, B.a12), cmul(A.a12, B.a22));
    r.a21 = cadd(cmul(A.a21, B.a11), cmul(A.a22, B.a21));
    r.a22 = cadd(cmul(A.a21, B.a12), cmul(A.a22, B.a22));
    return r;
}

template <class T>
static __device__ __forceinline__ mat4<T> m4add(const mat4<T> &A,
                                                const mat4<T> &B) {
    mat4<T> r;
    r.a11 = cadd(A.a11, B.a11);
    r.a12 = cadd(A.a12, B.a12);
    r.a21 = cadd(A.a21, B.a21);
    r.a22 = cadd(A.a22, B.a22);
    return r;
}

// inv(I - K)
template <class T>
static __device__ __forceinline__ mat4<T> m4inv_of_eye_minus(
        const mat4<T> &K) {
    cplx<T> m11 = cmk(T(1) - K.a11.re, -K.a11.im);
    cplx<T> m12 = cmk(-K.a12.re, -K.a12.im);
    cplx<T> m21 = cmk(-K.a21.re, -K.a21.im);
    cplx<T> m22 = cmk(T(1) - K.a22.re, -K.a22.im);
    cplx<T> idet = cinv(csub(cmul(m11, m22), cmul(m12, m21)));
    mat4<T> r;
    r.a11 = cmul(m22, idet);
    r.a12 = cmul(cneg(m12), idet);
    r.a21 = cmul(cneg(m21), idet);
    r.a22 = cmul(m11, idet);
    return r;
}

// P-SV R/T matrices of a welded interface (greens.cpp:19-85;
// pallas_rf._interface_coeffs).  out[0..3] = rd, td, ru, tu.
template <class T>
struct rt_table {
    cplx<T> rpp, a_core, b_core, tpp, tps, rss, tss, tsp;
};

template <class T>
static __device__ __forceinline__ rt_table<T> rt_half(
        cplx<T> d1, cplx<T> d2, T rho_i, cplx<T> aa, cplx<T> bb,
        cplx<T> cross, cplx<T> mix_a, cplx<T> mix_b, T rss_sign, T rho1,
        T rho2, T c, T t1, cplx<T> tb, cplx<T> t4, cplx<T> a1b2,
        cplx<T> a2b1) {
    rt_table<T> r;
    cplx<T> t5 = cinv(cadd(d1, d2));
    cplx<T> t7 = cscale(T(2) * rho_i, t5);
    r.rpp = cmul(csub(d2, d1), t5);
    cplx<T> core = cmul(t5, cross);
    r.a_core = cmul(aa, core);
    r.b_core = cmul(bb, core);
    r.tpp = cmul(aa, cmul(t7, tb));
    r.tps = cmul(aa, cmul(t7, cadd(creal(t1), cscale(c, mix_a))));
    r.rss = cmul(csub(csub(d2, d1),
                      cscale(rss_sign * T(2) * rho1 * rho2,
                             csub(a1b2, a2b1))),
                 t5);
    r.tss = cmul(bb, cmul(t7, t4));
    r.tsp = cmul(bb, cmul(t7, cadd(creal(t1), cscale(c, mix_b))));
    return r;
}

template <class T>
static __device__ __forceinline__ void interface_coeffs(
        T p, T vp1, T vs1, T rho1, T vp2, T vs2, T rho2, mat4<T> out[4]) {
    T mue1 = rho1 * vs1 * vs1;
    T mue2 = rho2 * vs2 * vs2;
    T c = T(2) * (mue1 - mue2);
    T u2 = p * p;
    T cu2 = c * u2;
    cplx<T> a1 = csqrt_conj_real(T(1) / (vp1 * vp1) - u2);
    cplx<T> a2 = csqrt_conj_real(T(1) / (vp2 * vp2) - u2);
    cplx<T> b1 = csqrt_conj_real(T(1) / (vs1 * vs1) - u2);
    cplx<T> b2 = csqrt_conj_real(T(1) / (vs2 * vs2) - u2);
    T t1 = cu2 - rho1 + rho2;
    T t2 = cu2 - rho1;
    T t3 = cu2 + rho2;
    cplx<T> t4 = csub(cscale(t3, a1), cscale(t2, a2));
    cplx<T> a1b1 = cmul(a1, b1);
    cplx<T> a2b2 = cmul(a2, b2);
    cplx<T> a1b2 = cmul(a1, b2);
    cplx<T> a2b1 = cmul(a2, b1);
    cplx<T> abab = cmul(a1b1, a2b2);
    cplx<T> tb = csub(cscale(t3, b1), cscale(t2, b2));
    T rr = rho1 * rho2;

    cplx<T> d1d = cadd(cadd(creal(t1 * t1 * u2), cscale(t2 * t2, a2b2)),
                       cscale(rr, a2b1));
    cplx<T> d2d = cadd(cadd(cscale(c * c * u2, abab), cscale(t3 * t3, a1b1)),
                       cscale(rr, a1b2));
    cplx<T> cross_d = cadd(creal(t1 * t3), cscale(c * t2, a2b2));
    rt_table<T> d = rt_half(d1d, d2d, rho1, a1, b1, cross_d, a2b1, a1b2,
                            T(1), rho1, rho2, c, t1, tb, t4, a1b2, a2b1);
    out[0].a11 = d.rpp;
    out[0].a12 = cscale(T(2) * p, d.b_core);
    out[0].a21 = cscale(T(-2) * p, d.a_core);
    out[0].a22 = d.rss;
    out[1].a11 = d.tpp;
    out[1].a12 = cscale(p, d.tsp);
    out[1].a21 = cscale(-p, d.tps);
    out[1].a22 = d.tss;

    cplx<T> d1u = cadd(cadd(creal(t1 * t1 * u2), cscale(t3 * t3, a1b1)),
                       cscale(rr, a1b2));
    cplx<T> d2u = cadd(cadd(cscale(c * c * u2, abab), cscale(t2 * t2, a2b2)),
                       cscale(rr, a2b1));
    cplx<T> cross_u = cadd(creal(t1 * t2), cscale(c * t3, a1b1));
    rt_table<T> u = rt_half(d1u, d2u, rho2, a2, b2, cross_u, a1b2, a2b1,
                            T(-1), rho1, rho2, c, t1, tb, t4, a1b2, a2b1);
    out[2].a11 = u.rpp;
    out[2].a12 = cscale(T(-2) * p, u.b_core);
    out[2].a21 = cscale(T(2) * p, u.a_core);
    out[2].a22 = u.rss;
    out[3].a11 = u.tpp;
    out[3].a12 = cscale(p, u.tsp);
    out[3].a21 = cscale(-p, u.tps);
    out[3].a22 = u.tss;
}

// free-surface P-SV reflection for upgoing waves (greens.cpp:87-112)
template <class T>
static __device__ __forceinline__ mat4<T> free_surface(T p, T vp, T vs) {
    T u2 = p * p;
    cplx<T> a = csqrt_plain_real(T(1) / (vp * vp) - u2);
    cplx<T> b = csqrt_plain_real(T(1) / (vs * vs) - u2);
    T t1 = T(2) * vs * vs;
    T t2 = t1 * u2 - T(1);
    cplx<T> ab = cscale(t1 * t1 * u2, cmul(a, b));
    cplx<T> d = cadd(creal(t2 * t2), ab);
    cplx<T> t3 = cdiv(creal(T(2) * t1 * p * t2), d);
    mat4<T> r;
    r.a11 = cdiv(csub(ab, creal(t2 * t2)), d);
    r.a12 = cscale(T(-1), cmul(b, t3));
    r.a21 = cmul(a, t3);
    r.a22 = r.a11;
    return r;
}

// free-surface displacement matrix (Mueller eq. 89)
template <class T>
static __device__ __forceinline__ mat4<T> displacement(T p, T vp, T vs) {
    T vs2 = vs * vs;
    T p2 = p * p;
    T x = T(1) - T(2) * vs2 * p2;
    cplx<T> a1 = csqrt_conj_real(T(1) / (vp * vp) - p2);
    cplx<T> b1 = csqrt_conj_real(T(1) / vs2 - p2);
    cplx<T> ab = cmul(a1, b1);
    cplx<T> q = cinv(cadd(creal(x * x), cscale(T(4) * vs2 * vs2 * p2, ab)));
    cplx<T> qpab = cmul(q, cscale(p, ab));
    mat4<T> r;
    r.a11 = cscale(T(2) * vs2, qpab);
    r.a12 = cscale(x, cmul(q, b1));
    r.a21 = cscale(x, cmul(q, a1));
    r.a22 = cscale(T(-2) * vs2, qpab);
    return r;
}
