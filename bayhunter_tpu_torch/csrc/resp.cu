// K3 and K3r: receiver-function transmission responses, one thread per
// (chain, frequency < cut) lane.
//
// K3 replaces the TPU kernel bayhunter_tpu/ops/pallas_rf.py:288
// (_resp_kernel in packed mode, driven by _resp_packed_t :834): uniform
// Q.  Plain twin: bayhunter_tpu_torch/ops/rf.py transmission_response.
//
// K3r replaces the same TPU kernel's row-major, array-Q arm
// (pallas_rf.py:288, driven by transmission_response_pallas :684,
// pallas_call :820): per-layer Qp/Qs planes and any reference
// frequency.  Plain twin: ops/rf.py transmission_response_q.
//
// Mueller (1985) reflectivity recursion on 2x2 complex matrices held as
// (re, im) float pairs (transmit below, shared by both kernels): phase
// terms exp(-i w h q) of each layer, the free surface on top, layers
// 1..depth (the chain's own skip depth from the pack; deeper slots are
// identities), then column WAVE (0 = P, 1 = SV incidence) of
// 2 hmat g times exp(i w t0).  Operands are K1's or K6's (rows, C)
// coefficient table and per-chain pack (pack.cuh).  The two kernels
// differ only in the phase terms: K3 scales 1/v^2 by one shared
// 1/u(w)^2 factor per wave (Qp 500, Qs 225, 1 Hz reference,
// pallas_rf.py:354-380); K3r builds each layer's complex velocity
// vc = v (1 + ln(w/wref)/(pi Q)) + i v/(2Q) from its own Q and inverts
// vc^2 (pallas_rf.py:382-388), and raises the chain's skip depth to the
// deepest slot with a Qp or Qs contrast below it (pallas_rf.py:804-811).
//
// Bound on the card: transcendental and complex arithmetic — per layer
// two complex square roots, two complex exponentials and ~450 flops
// per lane (K3r: ~36 more for the complex velocities), against 32
// coefficient loads that the chain's frequency lanes share through L1.
// The wave type is a template parameter, so each kernel instance holds
// one recursion (a runtime switch cost the walker K2 3.3 % and 5
// registers).  Left for later work: the coefficient reads are strided
// by C (broadcast within a warp, not vectorised), the per-layer phase
// factors are recomputed rather than shared, and the warps of one
// chain are not grouped by depth.
#include <cuda_runtime.h>

#include "cplx.cuh"
#include "pack.cuh"

namespace {

// K3's response; ops/rf.py holds the same constants
constexpr float QP = 500.0f;
constexpr float QS = 225.0f;
constexpr float WREF = 6.283185307179586f;  // 2 pi x 1 Hz
constexpr float PI_F = 3.14159265358979323846f;

__device__ __forceinline__ m4 load_m4(const float *__restrict__ coefs,
                                      int row, int C, int c) {
    m4 m;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(coefs + (size_t)(row + k) * C + c);
    m.a11 = cmk(v[0], v[1]);
    m.a12 = cmk(v[2], v[3]);
    m.a21 = cmk(v[4], v[5]);
    m.a22 = cmk(v[6], v[7]);
    return m;
}

// exp(-i w h qc) of the vertical slowness qc = sqrt(x)
__device__ __forceinline__ cf phase_of(cf x, float h_l, float w) {
    cf qc = csqrt_pair(x);
    return cexp_pair(cmk(w * h_l * qc.im, -w * h_l * qc.re));
}

// uniform Q: x = 1/v^2 / u(w)^2 - p^2
__device__ __forceinline__ cf phase(float v, float h_l, float w, float p,
                                    cf iu2) {
    float r = 1.0f / (v * v);
    return phase_of(cmk(iu2.re * r - p * p, iu2.im * r), h_l, w);
}

// per-layer Q: x = 1/vc^2 - p^2
__device__ __forceinline__ cf phase_q(float v, float q, float h_l, float w,
                                      float p, float lgw) {
    float piq = PI_F * q;
    cf vc = cmk(v * (1.0f + lgw / piq), v * (0.5f / q));
    cf iv2 = cinv(cmul(vc, vc));
    return phase_of(cmk(iv2.re - p * p, iv2.im), h_l, w);
}

__device__ __forceinline__ cf inv_u2(float lgw, float q) {
    float piq = PI_F * q;
    cf u = cmk(1.0f + lgw / piq, 0.5f / q);
    return cinv(cmul(u, u));
}

__device__ __forceinline__ m4 sandwich(const m4 &nt, cf e1, cf e2) {
    cf e12 = cmul(e1, e2);
    m4 nb;
    nb.a11 = cmul(nt.a11, cmul(e1, e1));
    nb.a12 = cmul(nt.a12, e12);
    nb.a21 = cmul(nt.a21, e12);
    nb.a22 = cmul(nt.a22, cmul(e2, e2));
    return nb;
}

__device__ __forceinline__ m4 columns(cf e1, cf e2, const m4 &q) {
    m4 r;
    r.a11 = cmul(e1, q.a11);
    r.a12 = cmul(e1, q.a12);
    r.a21 = cmul(e2, q.a21);
    r.a22 = cmul(e2, q.a22);
    return r;
}

// The recursion of one lane of chain c at angular frequency w, through
// layers 0..depth; phase(i, e1, e2) gives layer i's P and S phase terms.
// Writes the lane's (cz, cr) for incidence WAVE.
template <int WAVE, class Phase>
__device__ __forceinline__ void transmit(
        const float *__restrict__ coefs, const float *__restrict__ pack,
        const PackLayout &lay, int C, int c, float w, int depth,
        const Phase &phase_at, long lane, float *__restrict__ czr,
        float *__restrict__ czi, float *__restrict__ crr,
        float *__restrict__ cri) {
    auto P = [&](int row) { return __ldg(pack + (size_t)row * C + c); };
    float t0 = P(lay.t0);
    m4 hmat, nt;
    hmat.a11 = cmk(P(lay.hmat + 0), P(lay.hmat + 1));
    hmat.a12 = cmk(P(lay.hmat + 2), P(lay.hmat + 3));
    hmat.a21 = cmk(P(lay.hmat + 4), P(lay.hmat + 5));
    hmat.a22 = cmk(P(lay.hmat + 6), P(lay.hmat + 7));
    nt.a11 = cmk(P(lay.nt + 0), P(lay.nt + 1));
    nt.a12 = cmk(P(lay.nt + 2), P(lay.nt + 3));
    nt.a21 = cmk(P(lay.nt + 4), P(lay.nt + 5));
    nt.a22 = cmk(P(lay.nt + 6), P(lay.nt + 7));

    // layer 0: free surface on top
    cf e1, e2;
    phase_at(0, e1, e2);
    m4 rd_n = load_m4(coefs, 0, C, c);
    m4 td_i = load_m4(coefs, 8, C, c);
    m4 ru_n = load_m4(coefs, 16, C, c);
    m4 tu_n = load_m4(coefs, 24, C, c);
    m4 nb = sandwich(nt, e1, e2);
    m4 q = m4mul(m4inv_of_eye_minus(m4mul(rd_n, nb)), tu_n);
    m4 g = columns(e1, e2, q);
    m4 x = m4mul(nb, q);
    m4 ru = ru_n, td_prev = td_i;
    for (int i = 1; i <= depth; ++i) {
        phase_at(i, e1, e2);
        int base = i * 32;
        rd_n = load_m4(coefs, base, C, c);
        td_i = load_m4(coefs, base + 8, C, c);
        ru_n = load_m4(coefs, base + 16, C, c);
        tu_n = load_m4(coefs, base + 24, C, c);
        nb = sandwich(m4add(ru, m4mul(td_prev, x)), e1, e2);
        q = m4mul(m4inv_of_eye_minus(m4mul(rd_n, nb)), tu_n);
        x = m4mul(nb, q);
        g = m4mul(g, columns(e1, e2, q));
        ru = ru_n;
        td_prev = td_i;
    }

    // column WAVE of 2 hmat g: rows 0 (R) and 1 (Z)
    m4 t_full = m4mul(hmat, g);
    cf cr = cscale(2.0f, WAVE == 0 ? t_full.a11 : t_full.a12);
    cf cz = cscale(2.0f, WAVE == 0 ? t_full.a21 : t_full.a22);
    float wt0 = w * t0;
    cf qq = cmk(cosf(wt0), sinf(wt0));
    cz = cmul(cz, qq);
    cr = cmul(cr, qq);
    czr[lane] = cz.re;
    czi[lane] = cz.im;
    crr[lane] = cr.re;
    cri[lane] = cr.im;
}

template <int WAVE>
__global__ void resp_kernel(const float *__restrict__ coefs,
                            const float *__restrict__ pack, PackLayout lay,
                            int nl, int C, int F, int nfreq, float dw,
                            float *__restrict__ czr, float *__restrict__ czi,
                            float *__restrict__ crr,
                            float *__restrict__ cri) {
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (long)C * F) return;
    int c = (int)(lane / F);
    int f = (int)(lane % F);
    auto P = [&](int row) { return __ldg(pack + (size_t)row * C + c); };

    float jf = (float)min(f, nfreq - 1);
    float w = dw * jf;
    float lgw = jf > 0.0f ? logf(fmaxf(w, 1e-30f) / WREF) : 0.0f;
    cf iu2_p = inv_u2(lgw, QP);
    cf iu2_s = inv_u2(lgw, QS);
    float p = P(lay.p);
    int depth = min((int)P(lay.depth), nl - 2);
    auto phase_at = [&](int i, cf &e1, cf &e2) {
        float h_l = P(lay.h + i);
        e1 = phase(P(lay.vp + i), h_l, w, p, iu2_p);
        e2 = phase(P(lay.vs + i), h_l, w, p, iu2_s);
    };
    transmit<WAVE>(coefs, pack, lay, C, c, w, depth, phase_at, lane, czr,
                   czi, crr, cri);
}

template <int WAVE>
__global__ void resp_q_kernel(const float *__restrict__ coefs,
                              const float *__restrict__ pack,
                              const float *__restrict__ qp,
                              const float *__restrict__ qs, PackLayout lay,
                              int nl, int C, int F, int nfreq, float dw,
                              float wref, float *__restrict__ czr,
                              float *__restrict__ czi,
                              float *__restrict__ crr,
                              float *__restrict__ cri) {
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (long)C * F) return;
    int c = (int)(lane / F);
    int f = (int)(lane % F);
    auto P = [&](int row) { return __ldg(pack + (size_t)row * C + c); };
    auto Q = [&](const float *plane, int l) {
        return __ldg(plane + (size_t)l * C + c);
    };

    float jf = (float)min(f, nfreq - 1);
    float w = dw * jf;
    float lgw = jf > 0.0f ? logf(fmaxf(w, 1e-30f) / wref) : 0.0f;
    float p = P(lay.p);
    // the pack's depth counts elastic contrasts; a Q contrast below a
    // slot counts too
    int depth = (int)P(lay.depth);
    for (int l = depth + 1; l < nl - 1; ++l)
        if (Q(qp, l) != Q(qp, l + 1) || Q(qs, l) != Q(qs, l + 1)) depth = l;
    depth = min(depth, nl - 2);
    auto phase_at = [&](int i, cf &e1, cf &e2) {
        float h_l = P(lay.h + i);
        e1 = phase_q(P(lay.vp + i), Q(qp, i), h_l, w, p, lgw);
        e2 = phase_q(P(lay.vs + i), Q(qs, i), h_l, w, p, lgw);
    };
    transmit<WAVE>(coefs, pack, lay, C, c, w, depth, phase_at, lane, czr,
                   czi, crr, cri);
}

}  // namespace

extern "C" int bh_resp(const float *coefs, const float *pack,
                       PackLayout lay, int nl, int C, int F, int nsamp,
                       int wave, float dw, float *czr, float *czi,
                       float *crr, float *cri, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    long n = (long)C * F;
    if (n == 0) return 0;
    int threads = 128;
    int blocks = (int)((n + threads - 1) / threads);
    if (wave == 0)
        resp_kernel<0><<<blocks, threads, 0, stream>>>(
            coefs, pack, lay, nl, C, F, nsamp / 2 + 1, dw, czr, czi, crr, cri);
    else
        resp_kernel<1><<<blocks, threads, 0, stream>>>(
            coefs, pack, lay, nl, C, F, nsamp / 2 + 1, dw, czr, czi, crr, cri);
    return (int)cudaGetLastError();
}

extern "C" int bh_resp_q(const float *coefs, const float *pack,
                         const float *qp, const float *qs, PackLayout lay,
                         int nl, int C, int F, int nsamp, int wave, float dw,
                         float wref, float *czr, float *czi, float *crr,
                         float *cri, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    long n = (long)C * F;
    if (n == 0) return 0;
    int threads = 128;
    int blocks = (int)((n + threads - 1) / threads);
    if (wave == 0)
        resp_q_kernel<0><<<blocks, threads, 0, stream>>>(
            coefs, pack, qp, qs, lay, nl, C, F, nsamp / 2 + 1, dw, wref, czr,
            czi, crr, cri);
    else
        resp_q_kernel<1><<<blocks, threads, 0, stream>>>(
            coefs, pack, qp, qs, lay, nl, C, F, nsamp / 2 + 1, dw, wref, czr,
            czi, crr, cri);
    return (int)cudaGetLastError();
}
