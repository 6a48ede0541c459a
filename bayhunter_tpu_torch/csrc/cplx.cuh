// Complex (re, im) float pairs and 2x2 complex matrices, formula for
// formula as the (re, im) helpers of bayhunter_tpu/ops/pallas_rf.py
// (:73-148) and their plain twins in bayhunter_tpu_torch/ops/rf.py.
// No library complex type is used: the square-root branch cuts below
// decide the sign of the receiver function and must match the twins.
#pragma once

struct cf {
    float re, im;
};

// 2x2 complex matrix (m11, m12, m21, m22)
struct m4 {
    cf a11, a12, a21, a22;
};

static __device__ __forceinline__ cf cmk(float re, float im) {
    cf r;
    r.re = re;
    r.im = im;
    return r;
}

static __device__ __forceinline__ cf creal(float x) { return cmk(x, 0.0f); }

static __device__ __forceinline__ cf cmul(cf a, cf b) {
    return cmk(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

static __device__ __forceinline__ cf cadd(cf a, cf b) {
    return cmk(a.re + b.re, a.im + b.im);
}

static __device__ __forceinline__ cf csub(cf a, cf b) {
    return cmk(a.re - b.re, a.im - b.im);
}

static __device__ __forceinline__ cf cscale(float s, cf a) {
    return cmk(s * a.re, s * a.im);
}

static __device__ __forceinline__ cf cneg(cf a) { return cmk(-a.re, -a.im); }

static __device__ __forceinline__ cf cinv(cf a) {
    float d = a.re * a.re + a.im * a.im;
    return cmk(a.re / d, -a.im / d);
}

static __device__ __forceinline__ cf cdiv(cf a, cf b) { return cmul(a, cinv(b)); }

// principal square root
static __device__ __forceinline__ cf csqrt_pair(cf a) {
    float r = sqrtf(a.re * a.re + a.im * a.im);
    float re = sqrtf(fmaxf(0.5f * (r + a.re), 0.0f));
    float im_mag = sqrtf(fmaxf(0.5f * (r - a.re), 0.0f));
    return cmk(re, a.im < 0.0f ? -im_mag : im_mag);
}

static __device__ __forceinline__ cf cexp_pair(cf a) {
    float m = expf(a.re);
    return cmk(m * cosf(a.im), m * sinf(a.im));
}

// conj(sqrt(complex(x))) for real x (interface coefficients)
static __device__ __forceinline__ cf csqrt_conj_real(float x) {
    return cmk(sqrtf(fmaxf(x, 0.0f)), -sqrtf(fmaxf(-x, 0.0f)));
}

static __device__ __forceinline__ cf csqrt_plain_real(float x) {
    return cmk(sqrtf(fmaxf(x, 0.0f)), sqrtf(fmaxf(-x, 0.0f)));
}

static __device__ __forceinline__ m4 m4mul(const m4 &A, const m4 &B) {
    m4 r;
    r.a11 = cadd(cmul(A.a11, B.a11), cmul(A.a12, B.a21));
    r.a12 = cadd(cmul(A.a11, B.a12), cmul(A.a12, B.a22));
    r.a21 = cadd(cmul(A.a21, B.a11), cmul(A.a22, B.a21));
    r.a22 = cadd(cmul(A.a21, B.a12), cmul(A.a22, B.a22));
    return r;
}

static __device__ __forceinline__ m4 m4add(const m4 &A, const m4 &B) {
    m4 r;
    r.a11 = cadd(A.a11, B.a11);
    r.a12 = cadd(A.a12, B.a12);
    r.a21 = cadd(A.a21, B.a21);
    r.a22 = cadd(A.a22, B.a22);
    return r;
}

// inv(I - K)
static __device__ __forceinline__ m4 m4inv_of_eye_minus(const m4 &K) {
    cf m11 = cmk(1.0f - K.a11.re, -K.a11.im);
    cf m12 = cmk(-K.a12.re, -K.a12.im);
    cf m21 = cmk(-K.a21.re, -K.a21.im);
    cf m22 = cmk(1.0f - K.a22.re, -K.a22.im);
    cf idet = cinv(csub(cmul(m11, m22), cmul(m12, m21)));
    m4 r;
    r.a11 = cmul(m22, idet);
    r.a12 = cmul(cneg(m12), idet);
    r.a21 = cmul(cneg(m21), idet);
    r.a22 = cmul(m11, idet);
    return r;
}

// P-SV R/T matrices of a welded interface (greens.cpp:19-85;
// pallas_rf._interface_coeffs).  out[0..3] = rd, td, ru, tu.
struct rt_table {
    cf rpp, a_core, b_core, tpp, tps, rss, tss, tsp;
};

static __device__ __forceinline__ rt_table rt_half(
        cf d1, cf d2, float rho_i, cf aa, cf bb, cf cross, cf mix_a,
        cf mix_b, float rss_sign, float rho1, float rho2, float c,
        float t1, cf tb, cf t4, cf a1b2, cf a2b1) {
    rt_table r;
    cf t5 = cinv(cadd(d1, d2));
    cf t7 = cscale(2.0f * rho_i, t5);
    r.rpp = cmul(csub(d2, d1), t5);
    cf core = cmul(t5, cross);
    r.a_core = cmul(aa, core);
    r.b_core = cmul(bb, core);
    r.tpp = cmul(aa, cmul(t7, tb));
    r.tps = cmul(aa, cmul(t7, cadd(creal(t1), cscale(c, mix_a))));
    r.rss = cmul(csub(csub(d2, d1),
                      cscale(rss_sign * 2.0f * rho1 * rho2, csub(a1b2, a2b1))),
                 t5);
    r.tss = cmul(bb, cmul(t7, t4));
    r.tsp = cmul(bb, cmul(t7, cadd(creal(t1), cscale(c, mix_b))));
    return r;
}

static __device__ __forceinline__ void interface_coeffs(
        float p, float vp1, float vs1, float rho1, float vp2, float vs2,
        float rho2, m4 out[4]) {
    float mue1 = rho1 * vs1 * vs1;
    float mue2 = rho2 * vs2 * vs2;
    float c = 2.0f * (mue1 - mue2);
    float u2 = p * p;
    float cu2 = c * u2;
    cf a1 = csqrt_conj_real(1.0f / (vp1 * vp1) - u2);
    cf a2 = csqrt_conj_real(1.0f / (vp2 * vp2) - u2);
    cf b1 = csqrt_conj_real(1.0f / (vs1 * vs1) - u2);
    cf b2 = csqrt_conj_real(1.0f / (vs2 * vs2) - u2);
    float t1 = cu2 - rho1 + rho2;
    float t2 = cu2 - rho1;
    float t3 = cu2 + rho2;
    cf t4 = csub(cscale(t3, a1), cscale(t2, a2));
    cf a1b1 = cmul(a1, b1);
    cf a2b2 = cmul(a2, b2);
    cf a1b2 = cmul(a1, b2);
    cf a2b1 = cmul(a2, b1);
    cf abab = cmul(a1b1, a2b2);
    cf tb = csub(cscale(t3, b1), cscale(t2, b2));
    float rr = rho1 * rho2;

    cf d1d = cadd(cadd(creal(t1 * t1 * u2), cscale(t2 * t2, a2b2)),
                  cscale(rr, a2b1));
    cf d2d = cadd(cadd(cscale(c * c * u2, abab), cscale(t3 * t3, a1b1)),
                  cscale(rr, a1b2));
    cf cross_d = cadd(creal(t1 * t3), cscale(c * t2, a2b2));
    rt_table d = rt_half(d1d, d2d, rho1, a1, b1, cross_d, a2b1, a1b2, 1.0f,
                         rho1, rho2, c, t1, tb, t4, a1b2, a2b1);
    out[0].a11 = d.rpp;
    out[0].a12 = cscale(2.0f * p, d.b_core);
    out[0].a21 = cscale(-2.0f * p, d.a_core);
    out[0].a22 = d.rss;
    out[1].a11 = d.tpp;
    out[1].a12 = cscale(p, d.tsp);
    out[1].a21 = cscale(-p, d.tps);
    out[1].a22 = d.tss;

    cf d1u = cadd(cadd(creal(t1 * t1 * u2), cscale(t3 * t3, a1b1)),
                  cscale(rr, a1b2));
    cf d2u = cadd(cadd(cscale(c * c * u2, abab), cscale(t2 * t2, a2b2)),
                  cscale(rr, a2b1));
    cf cross_u = cadd(creal(t1 * t2), cscale(c * t3, a1b1));
    rt_table u = rt_half(d1u, d2u, rho2, a2, b2, cross_u, a1b2, a2b1, -1.0f,
                         rho1, rho2, c, t1, tb, t4, a1b2, a2b1);
    out[2].a11 = u.rpp;
    out[2].a12 = cscale(-2.0f * p, u.b_core);
    out[2].a21 = cscale(2.0f * p, u.a_core);
    out[2].a22 = u.rss;
    out[3].a11 = u.tpp;
    out[3].a12 = cscale(p, u.tsp);
    out[3].a21 = cscale(-p, u.tps);
    out[3].a22 = u.tss;
}

// free-surface P-SV reflection for upgoing waves (greens.cpp:87-112)
static __device__ __forceinline__ m4 free_surface(float p, float vp, float vs) {
    float u2 = p * p;
    cf a = csqrt_plain_real(1.0f / (vp * vp) - u2);
    cf b = csqrt_plain_real(1.0f / (vs * vs) - u2);
    float t1 = 2.0f * vs * vs;
    float t2 = t1 * u2 - 1.0f;
    cf ab = cscale(t1 * t1 * u2, cmul(a, b));
    cf d = cadd(creal(t2 * t2), ab);
    cf t3 = cdiv(creal(2.0f * t1 * p * t2), d);
    m4 r;
    r.a11 = cdiv(csub(ab, creal(t2 * t2)), d);
    r.a12 = cscale(-1.0f, cmul(b, t3));
    r.a21 = cmul(a, t3);
    r.a22 = r.a11;
    return r;
}

// free-surface displacement matrix (Mueller eq. 89)
static __device__ __forceinline__ m4 displacement(float p, float vp, float vs) {
    float vs2 = vs * vs;
    float p2 = p * p;
    float x = 1.0f - 2.0f * vs2 * p2;
    cf a1 = csqrt_conj_real(1.0f / (vp * vp) - p2);
    cf b1 = csqrt_conj_real(1.0f / vs2 - p2);
    cf ab = cmul(a1, b1);
    cf q = cinv(cadd(creal(x * x), cscale(4.0f * vs2 * vs2 * p2, ab)));
    cf qpab = cmul(q, cscale(p, ab));
    m4 r;
    r.a11 = cscale(2.0f * vs2, qpab);
    r.a12 = cscale(x, cmul(q, b1));
    r.a21 = cscale(x, cmul(q, a1));
    r.a22 = cscale(-2.0f * vs2, qpab);
    return r;
}
