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
// Both take the options bitmask of the JAX package's XLA ``synrf``
// (bayhunter_tpu/ops/rf.py:48-57, :327-466) as a template parameter:
// SUPPRESS_MULTIPLES (the direct transmission without reverberations)
// and WITHOUT_ANELASTICITY (real velocities in the phase terms); the
// TPU kernel has no options, so these arms' twins are the same plain
// functions with the same flag.  A suppressed slot below the skip depth
// is an identity (tu = I, e = I) as in the full recursion, so the pack's
// depth stays valid in every arm.
//
// Bound on the card: the float32 instruction stream — per layer and
// lane two complex square roots, two complex exponentials, ~450 flops
// and the IEEE divisions of the complex inverses (K3r: four more
// divisions and ~36 flops for the complex velocities), built with
// --fmad=false so that the square roots' branch cuts and every output
// equal the twins' bit for bit.  The operands are ~130 bytes per layer
// and chain, shared by the chain's F = 99 (warm) or 257 (cold) lanes.
// The design:
//   * a block takes a tile of whole chains (all F lanes of each; the
//     wrapper's resp.geometry picks the tile of at most five chains and
//     the block size that waste the fewest thread slots) and stages,
//     with loads coalesced across the tile's chains, each chain's
//     coefficient rows of layers 0..depth (read by a lane as eight
//     16-byte shared loads per layer, broadcast to the chain's lanes),
//     its pack scalars and its per-layer phase operands;
//   * the staging pass computes the frequency-invariant terms once per
//     chain and layer (K3: 1 / v^2 and p^2; K3r: pi Q, v (0.5 / Q) and
//     the skip depth raised by the Q contrasts), each from the twins'
//     own expression;
//   * the recursion re-reads the previous layer's ru and td from
//     shared memory instead of carrying them, which lets the launch
//     bound hold a thread to 64 registers without spills: 32 resident
//     warps per SM, against 20 for the 96-register thread it replaces.
// Left for later: K3r's per-lane complex velocity (four divisions per
// layer and wave, ln w over pi Q), and the transcendental functions,
// which run at full precision and unfused for parity with the twins.
#include <cuda_runtime.h>

#include "cplx.cuh"
#include "pack.cuh"

namespace {

// K3's response; ops/rf.py holds the same constants
constexpr float QP = 500.0f;
constexpr float QS = 225.0f;
constexpr float WREF = 6.283185307179586f;  // 2 pi x 1 Hz
constexpr float PI_F = 3.14159265358979323846f;

constexpr int RESP_MAX_THREADS = 256;   // ops/resp.py MAX_THREADS
// resident blocks per SM that the register allocation must allow at
// RESP_MAX_THREADS threads (__launch_bounds__): 4 caps a thread at 64
// registers, 32 warps per SM, without spills
constexpr int RESP_MIN_BLOCKS = 4;
// per-chain scalars after the per-layer terms: p, p^2, t0, depth, hmat
// (8), nt (8)
constexpr int SC_P = 0, SC_PP = 1, SC_T0 = 2, SC_DEPTH = 3, SC_HMAT = 4,
              SC_NT = 12, N_SC = 20;

// one 2x2 complex matrix (8 floats, 16-byte aligned) from shared memory
__device__ __forceinline__ m4 lds_m4(const float *p) {
    float4 a = reinterpret_cast<const float4 *>(p)[0];
    float4 b = reinterpret_cast<const float4 *>(p)[1];
    m4 m;
    m.a11 = cmk(a.x, a.y);
    m.a12 = cmk(a.z, a.w);
    m.a21 = cmk(b.x, b.y);
    m.a22 = cmk(b.z, b.w);
    return m;
}

__device__ __forceinline__ m4 m4_of(const float *v) {
    m4 m;
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

// uniform Q: x = 1/v^2 / u(w)^2 - p^2, from r = 1/v^2 and pp = p^2
__device__ __forceinline__ cf phase(float r, float h_l, float w, float pp,
                                    cf iu2) {
    return phase_of(cmk(iu2.re * r - pp, iu2.im * r), h_l, w);
}

// per-layer Q: x = 1/vc^2 - p^2, from piq = pi Q and vim = v (0.5 / Q)
__device__ __forceinline__ cf phase_q(float v, float piq, float vim,
                                      float h_l, float w, float pp,
                                      float lgw) {
    cf vc = cmk(v * (1.0f + lgw / piq), vim);
    cf iv2 = cinv(cmul(vc, vc));
    return phase_of(cmk(iv2.re - pp, iv2.im), h_l, w);
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

// The recursion of one lane at angular frequency w through layers
// 0..depth of a staged chain: ``coef`` its coefficient rows (layer i at
// i * 32: rd, td, ru, tu, 8 floats each), ``sc`` its scalars;
// phase_at(i, e1, e2) gives layer i's P and S phase terms.  Writes the
// lane's (cz, cr) for incidence WAVE at ``out``.  SUPPRESS: the direct
// downward transmission g = prod_i e_i tu_{i+1}, no reverberations
// (rf.py step_suppress, :445-455).
template <int WAVE, bool SUPPRESS, class Phase>
__device__ __forceinline__ void transmit(
        const float *coef, const float *sc, float w, int depth,
        const Phase &phase_at, size_t out, float *__restrict__ czr,
        float *__restrict__ czi, float *__restrict__ crr,
        float *__restrict__ cri) {
    cf e1, e2;
    phase_at(0, e1, e2);
    m4 g;
    if constexpr (SUPPRESS) {
        g = columns(e1, e2, lds_m4(coef + 24));
        for (int i = 1; i <= depth; ++i) {
            phase_at(i, e1, e2);
            g = m4mul(g, columns(e1, e2, lds_m4(coef + i * 32 + 24)));
        }
    } else {
        // layer 0: free surface on top
        m4 nb = sandwich(m4_of(sc + SC_NT), e1, e2);
        m4 q = m4mul(m4inv_of_eye_minus(m4mul(lds_m4(coef), nb)),
                     lds_m4(coef + 24));
        g = columns(e1, e2, q);
        m4 x = m4mul(nb, q);
        for (int i = 1; i <= depth; ++i) {
            phase_at(i, e1, e2);
            const float *prev = coef + (i - 1) * 32;  // ru, td of i - 1
            const float *cur = coef + i * 32;
            nb = sandwich(m4add(lds_m4(prev + 16),
                                m4mul(lds_m4(prev + 8), x)),
                          e1, e2);
            q = m4mul(m4inv_of_eye_minus(m4mul(lds_m4(cur), nb)),
                      lds_m4(cur + 24));
            x = m4mul(nb, q);
            g = m4mul(g, columns(e1, e2, q));
        }
    }

    // column WAVE of 2 hmat g: rows 0 (R) and 1 (Z)
    m4 t_full = m4mul(m4_of(sc + SC_HMAT), g);
    cf cr = cscale(2.0f, WAVE == 0 ? t_full.a11 : t_full.a12);
    cf cz = cscale(2.0f, WAVE == 0 ? t_full.a21 : t_full.a22);
    float wt0 = w * sc[SC_T0];
    cf qq = cmk(cosf(wt0), sinf(wt0));
    cz = cmul(cz, qq);
    cr = cmul(cr, qq);
    czr[out] = cz.re;
    czi[out] = cz.im;
    crr[out] = cr.re;
    cri[out] = cr.im;
}

// Shared-memory record of chain cc of the tile, ``cs`` floats from
// sm + cc * cs (ops/resp.py geometry mirrors it):
//   [0, (nl-1)*32)             coefficient rows of layers 0..depth
//   then NK planes of nl       per-layer terms: h, then K3 and every
//                              elastic arm: 1/vp^2, 1/vs^2; K3r: vp, vs,
//                              pi qp, vp (0.5/qp), pi qs, vs (0.5/qs)
//   then N_SC scalars          p, p^2, t0, depth (an int), hmat, nt
// OPT is the options bitmask (rf.py SUPPRESS_MULTIPLES = 1,
// WITHOUT_ANELASTICITY = 2): the suppress arm runs the direct
// transmission (transmit), the elastic arm takes real velocities in the
// phase terms, x = 1/v^2 - p^2 with a zero imaginary part and the
// vertical slowness sqrt(x) still complex (rf.py:372-379), in place of
// K3's uniform Q and of K3r's per-layer Q (whose contrasts still raise
// the skip depth).
template <int WAVE, bool QMODE, int OPT>
__global__ void __launch_bounds__(RESP_MAX_THREADS, RESP_MIN_BLOCKS)
resp_kernel(const float *__restrict__ coefs, const float *__restrict__ pack,
            const float *__restrict__ qp, const float *__restrict__ qs,
            PackLayout lay, int nl, int C, int F, int nfreq, float dw,
            float wref, int tile, int cs, float *__restrict__ czr,
            float *__restrict__ czi, float *__restrict__ crr,
            float *__restrict__ cri) {
    constexpr int NK = QMODE ? 7 : 3;
    constexpr bool SUPPRESS = (OPT & 1) != 0;
    constexpr bool ELASTIC = (OPT & 2) != 0;
    extern __shared__ float4 smem4[];
    float *sm = reinterpret_cast<float *>(smem4);
    int *s_rows = reinterpret_cast<int *>(sm + tile * cs);  // staged rows
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int c_base = blockIdx.x * tile;
    const int tc = min(tile, C - c_base);
    const int ncoef = (nl - 1) * 32;
    const int k_off = ncoef, s_off = ncoef + NK * nl;
    auto rec = [&](int cc) { return sm + cc * cs; };
    auto P = [&](int row, int cc) {
        return __ldg(pack + (size_t)row * C + c_base + cc);
    };

    // pack scalars (the depth as the pack has it), chain-fastest
    constexpr int NROW = 3 + 16;
    for (int i = tid; i < NROW * tc; i += T) {
        int k = i / tc, cc = i - k * tc;
        float *sc = rec(cc) + s_off;
        if (k == 0) {
            float p = P(lay.p, cc);
            sc[SC_P] = p;
            sc[SC_PP] = p * p;
        } else if (k == 1) {
            sc[SC_T0] = P(lay.t0, cc);
        } else if (k == 2) {
            reinterpret_cast<int *>(sc)[SC_DEPTH] = (int)P(lay.depth, cc);
        } else if (k < 11) {
            sc[SC_HMAT + k - 3] = P(lay.hmat + k - 3, cc);
        } else {
            sc[SC_NT + k - 11] = P(lay.nt + k - 11, cc);
        }
    }
    if (tid == 0) *s_rows = 0;
    __syncthreads();
    if constexpr (QMODE) {
        // the pack's depth counts elastic contrasts; a Q contrast below
        // a slot counts too
        for (int i = tid; i < (nl - 1) * tc; i += T) {
            int l = i / tc, cc = i - l * tc;
            const float *a = qp + (size_t)l * C + c_base + cc;
            const float *b = qs + (size_t)l * C + c_base + cc;
            if (__ldg(a) != __ldg(a + C) || __ldg(b) != __ldg(b + C))
                atomicMax(reinterpret_cast<int *>(rec(cc) + s_off) + SC_DEPTH,
                          l);
        }
        __syncthreads();
    }
    for (int cc = tid; cc < tc; cc += T) {
        int *d = reinterpret_cast<int *>(rec(cc) + s_off) + SC_DEPTH;
        *d = min(*d, nl - 2);
        atomicMax(s_rows, (*d + 1) * 32);
    }
    __syncthreads();

    // per-layer terms of layers 0..depth, then the coefficient rows
    for (int i = tid; i < nl * tc; i += T) {
        int l = i / tc, cc = i - l * tc;
        float *r = rec(cc);
        if (l > reinterpret_cast<const int *>(r + s_off)[SC_DEPTH]) continue;
        float *kp = r + k_off + l;
        float vp = P(lay.vp + l, cc), vs = P(lay.vs + l, cc);
        kp[0] = P(lay.h + l, cc);
        if constexpr (QMODE && !ELASTIC) {
            float qpl = __ldg(qp + (size_t)l * C + c_base + cc);
            float qsl = __ldg(qs + (size_t)l * C + c_base + cc);
            kp[nl] = vp;
            kp[2 * nl] = vs;
            kp[3 * nl] = PI_F * qpl;
            kp[4 * nl] = vp * (0.5f / qpl);
            kp[5 * nl] = PI_F * qsl;
            kp[6 * nl] = vs * (0.5f / qsl);
        } else {
            kp[nl] = 1.0f / (vp * vp);
            kp[2 * nl] = 1.0f / (vs * vs);
        }
    }
    const int rows = *s_rows;
    for (int i = tid; i < rows * tc; i += T) {
        int row = i / tc, cc = i - row * tc;
        float *r = rec(cc);
        int depth = reinterpret_cast<const int *>(r + s_off)[SC_DEPTH];
        if (row < (depth + 1) * 32)
            r[row] = __ldg(coefs + (size_t)row * C + c_base + cc);
    }
    __syncthreads();

    for (int j = tid; j < tc * F; j += T) {
        const int cc = j / F;
        const int f = j - cc * F;
        const float *r = rec(cc);
        const float *kt = r + k_off;
        const float *sc = r + s_off;
        const int depth = reinterpret_cast<const int *>(sc)[SC_DEPTH];
        const float pp = sc[SC_PP];
        const size_t out = (size_t)c_base * F + j;
        float jf = (float)min(f, nfreq - 1);
        float w = dw * jf;
        float lgw = jf > 0.0f ? logf(fmaxf(w, 1e-30f) / wref) : 0.0f;
        if constexpr (ELASTIC) {
            auto phase_at = [&](int i, cf &e1, cf &e2) {
                float h_l = kt[i];
                e1 = phase_of(cmk(kt[nl + i] - pp, 0.0f), h_l, w);
                e2 = phase_of(cmk(kt[2 * nl + i] - pp, 0.0f), h_l, w);
            };
            transmit<WAVE, SUPPRESS>(r, sc, w, depth, phase_at, out, czr,
                                     czi, crr, cri);
        } else if constexpr (QMODE) {
            auto phase_at = [&](int i, cf &e1, cf &e2) {
                float h_l = kt[i];
                e1 = phase_q(kt[nl + i], kt[3 * nl + i], kt[4 * nl + i], h_l,
                             w, pp, lgw);
                e2 = phase_q(kt[2 * nl + i], kt[5 * nl + i], kt[6 * nl + i],
                             h_l, w, pp, lgw);
            };
            transmit<WAVE, SUPPRESS>(r, sc, w, depth, phase_at, out, czr,
                                     czi, crr, cri);
        } else {
            cf iu2_p = inv_u2(lgw, QP);
            cf iu2_s = inv_u2(lgw, QS);
            auto phase_at = [&](int i, cf &e1, cf &e2) {
                float h_l = kt[i];
                e1 = phase(kt[nl + i], h_l, w, pp, iu2_p);
                e2 = phase(kt[2 * nl + i], h_l, w, pp, iu2_s);
            };
            transmit<WAVE, SUPPRESS>(r, sc, w, depth, phase_at, out, czr,
                                     czi, crr, cri);
        }
    }
}

template <int WAVE, bool QMODE, int OPT>
int launch(const float *coefs, const float *pack, const float *qp,
           const float *qs, PackLayout lay, int nl, int C, int F, int nsamp,
           float dw, float wref, int threads, int tile, int cs, int smem,
           float *czr, float *czi, float *crr, float *cri,
           cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            resp_kernel<WAVE, QMODE, OPT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    int blocks = (C + tile - 1) / tile;
    resp_kernel<WAVE, QMODE, OPT><<<blocks, threads, smem, stream>>>(
        coefs, pack, qp, qs, lay, nl, C, F, nsamp / 2 + 1, dw, wref, tile,
        cs, czr, czi, crr, cri);
    return (int)cudaGetLastError();
}

using Launch = int (*)(const float *, const float *, const float *,
                       const float *, PackLayout, int, int, int, int, float,
                       float, int, int, int, int, float *, float *, float *,
                       float *, cudaStream_t);

// the instance of incidence ``wave`` and options bitmask ``options``
template <bool QMODE>
Launch arm(int wave, int options) {
    static const Launch table[8] = {
        launch<0, QMODE, 0>, launch<0, QMODE, 1>, launch<0, QMODE, 2>,
        launch<0, QMODE, 3>, launch<1, QMODE, 0>, launch<1, QMODE, 1>,
        launch<1, QMODE, 2>, launch<1, QMODE, 3>};
    return table[wave * 4 + options];
}

int check_geometry(int nl, int threads, int tile, int cs, int smem, int nk) {
    if (threads < 32 || threads > RESP_MAX_THREADS || threads % 32 != 0
        || tile < 1 || nl < 2 || cs % 4 != 0
        || cs < (nl - 1) * 32 + nk * nl + N_SC
        || smem < (tile * cs + 1) * 4)
        return (int)cudaErrorInvalidConfiguration;
    return 0;
}

}  // namespace

// threads, tile, the chain record's floats cs and smem come from
// ops/resp.py geometry; options is the bitmask of rf.py
// SUPPRESS_MULTIPLES (1) and WITHOUT_ANELASTICITY (2)
extern "C" int bh_resp(const float *coefs, const float *pack,
                       PackLayout lay, int nl, int C, int F, int nsamp,
                       int wave, int options, float dw, int threads,
                       int tile, int cs, int smem, float *czr, float *czi,
                       float *crr, float *cri, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (options < 0 || options > 3) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, cs, smem, 3)) return e;
    if ((long)C * F == 0) return 0;
    return arm<false>(wave, options)(coefs, pack, nullptr, nullptr, lay, nl,
                                     C, F, nsamp, dw, WREF, threads, tile,
                                     cs, smem, czr, czi, crr, cri, stream);
}

extern "C" int bh_resp_q(const float *coefs, const float *pack,
                         const float *qp, const float *qs, PackLayout lay,
                         int nl, int C, int F, int nsamp, int wave,
                         int options, float dw, float wref, int threads,
                         int tile, int cs, int smem, float *czr, float *czi,
                         float *crr, float *cri, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (options < 0 || options > 3) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, cs, smem, 7)) return e;
    if ((long)C * F == 0) return 0;
    return arm<true>(wave, options)(coefs, pack, qp, qs, lay, nl, C, F,
                                    nsamp, dw, wref, threads, tile, cs, smem,
                                    czr, czi, crr, cri, stream);
}
