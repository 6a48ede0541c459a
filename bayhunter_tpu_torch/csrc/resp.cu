// K3: receiver-function transmission response, one thread per
// (chain, frequency < cut) lane.
//
// Replaces the TPU kernel bayhunter_tpu/ops/pallas_rf.py:288
// (_resp_kernel in packed mode, driven by _resp_packed_t :834).  Plain
// twin: bayhunter_tpu_torch/ops/rf.py transmission_response.
//
// Mueller (1985) reflectivity recursion on 2x2 complex matrices held as
// (re, im) float pairs: uniform-Q phase terms exp(-i w h q) with the
// shared 1/u(w)^2 factor (Qp 500, Qs 225, 1 Hz reference), the free
// surface on top, layers 1..depth (the chain's own skip depth from the
// pack; deeper slots are identities), then the incident P column of
// 2 hmat g times exp(i w t0).  Operands are the model kernel's
// (rows, C) coefficient table and per-chain pack (pack.cuh).
//
// Bound on the card: transcendental and complex arithmetic — per layer
// two complex square roots, two complex exponentials and ~400 flops
// per lane, against 32 coefficient loads that the chain's frequency
// lanes share through L1.  Left for later work: the coefficient reads
// are strided by C (broadcast within a warp, not vectorised), the
// per-layer phase factors are recomputed rather than shared, and the
// warps of one chain are not grouped by depth.
#include <cuda_runtime.h>

#include "cplx.cuh"
#include "pack.cuh"

namespace {

// the main path's response; ops/rf.py holds the same constants
constexpr float QP = 500.0f;
constexpr float QS = 225.0f;
constexpr float WREF = 6.283185307179586f;  // 2 pi x 1 Hz

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

__device__ __forceinline__ cf phase(float v, float h_l, float w, float p,
                                    cf iu2) {
    float r = 1.0f / (v * v);
    cf qc = csqrt_pair(cmk(iu2.re * r - p * p, iu2.im * r));
    return cexp_pair(cmk(w * h_l * qc.im, -w * h_l * qc.re));
}

__device__ __forceinline__ cf inv_u2(float lgw, float q) {
    float piq = 3.14159265358979323846f * q;
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
    int depth = min((int)P(lay.depth), nl - 2);

    // layer 0: free surface on top
    float h0 = P(lay.h);
    cf e1 = phase(P(lay.vp), h0, w, p, iu2_p);
    cf e2 = phase(P(lay.vs), h0, w, p, iu2_s);
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
        float h_l = P(lay.h + i);
        e1 = phase(P(lay.vp + i), h_l, w, p, iu2_p);
        e2 = phase(P(lay.vs + i), h_l, w, p, iu2_s);
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

    m4 t_full = m4mul(hmat, g);
    cf cr = cscale(2.0f, t_full.a11);
    cf cz = cscale(2.0f, t_full.a21);
    float wt0 = w * t0;
    cf qq = cmk(cosf(wt0), sinf(wt0));
    cz = cmul(cz, qq);
    cr = cmul(cr, qq);
    czr[lane] = cz.re;
    czi[lane] = cz.im;
    crr[lane] = cr.re;
    cri[lane] = cr.im;
}

}  // namespace

extern "C" int bh_resp(const float *coefs, const float *pack,
                       PackLayout lay, int nl, int C, int F, int nsamp,
                       float dw, float *czr, float *czi, float *crr,
                       float *cri, cudaStream_t stream) {
    long n = (long)C * F;
    if (n == 0) return 0;
    int threads = 128;
    int blocks = (int)((n + threads - 1) / threads);
    resp_kernel<<<blocks, threads, 0, stream>>>(
        coefs, pack, lay, nl, C, F, nsamp / 2 + 1, dw, czr, czi, crr, cri);
    return (int)cudaGetLastError();
}
