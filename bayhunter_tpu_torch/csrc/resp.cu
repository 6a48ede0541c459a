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

// K3's response; ops/rf.py holds the same constants (Qp 500, Qs 225,
// the reference frequency 1 Hz: 2 pi x 1 Hz, passed to the kernel)
constexpr double QP = 500.0;
constexpr double QS = 225.0;
constexpr double WREF = 6.283185307179586;  // 2 pi x 1 Hz
constexpr double PI_D = 3.14159265358979323846;

constexpr int RESP_MAX_THREADS = 256;   // ops/resp.py MAX_THREADS
// resident blocks per SM that the register allocation must allow at
// RESP_MAX_THREADS threads (__launch_bounds__): 4 caps a float thread
// at 64 registers, 32 warps per SM, without spills; a double thread
// holds twice the bytes in every value and takes 2 (128 registers)
template <class T>
constexpr int resp_min_blocks() { return sizeof(T) == 4 ? 4 : 2; }
// per-chain scalars after the per-layer terms: p, p^2, t0, depth, hmat
// (8), nt (8)
constexpr int SC_P = 0, SC_PP = 1, SC_T0 = 2, SC_DEPTH = 3, SC_HMAT = 4,
              SC_NT = 12, N_SC = 20;

// one 2x2 complex matrix (8 values, 16-byte aligned) from shared memory
template <class T>
__device__ __forceinline__ mat4<T> lds_m4(const T *p) {
    mat4<T> m;
    if constexpr (sizeof(T) == 4) {
        float4 a = reinterpret_cast<const float4 *>(p)[0];
        float4 b = reinterpret_cast<const float4 *>(p)[1];
        m.a11 = cmk(a.x, a.y);
        m.a12 = cmk(a.z, a.w);
        m.a21 = cmk(b.x, b.y);
        m.a22 = cmk(b.z, b.w);
    } else {
        const double2 *q = reinterpret_cast<const double2 *>(p);
        double2 a = q[0], b = q[1], c = q[2], d = q[3];
        m.a11 = cmk(a.x, a.y);
        m.a12 = cmk(b.x, b.y);
        m.a21 = cmk(c.x, c.y);
        m.a22 = cmk(d.x, d.y);
    }
    return m;
}

template <class T>
__device__ __forceinline__ mat4<T> m4_of(const T *v) {
    mat4<T> m;
    m.a11 = cmk(v[0], v[1]);
    m.a12 = cmk(v[2], v[3]);
    m.a21 = cmk(v[4], v[5]);
    m.a22 = cmk(v[6], v[7]);
    return m;
}

// a chain's skip depth, an int in its record's SC_DEPTH slot
template <class T>
__device__ __forceinline__ int *depth_slot(T *sc) {
    return reinterpret_cast<int *>(sc + SC_DEPTH);
}

template <class T>
__device__ __forceinline__ int depth_of(const T *sc) {
    return *reinterpret_cast<const int *>(sc + SC_DEPTH);
}

// exp(-i w h qc) of the vertical slowness qc = sqrt(x)
template <class T>
__device__ __forceinline__ cplx<T> phase_of(cplx<T> x, T h_l, T w) {
    cplx<T> qc = csqrt_pair(x);
    return cexp_pair(cmk(w * h_l * qc.im, -w * h_l * qc.re));
}

// uniform Q: x = 1/v^2 / u(w)^2 - p^2, from r = 1/v^2 and pp = p^2
template <class T>
__device__ __forceinline__ cplx<T> phase(T r, T h_l, T w, T pp,
                                         cplx<T> iu2) {
    return phase_of(cmk(iu2.re * r - pp, iu2.im * r), h_l, w);
}

// per-layer Q: x = 1/vc^2 - p^2, from piq = pi Q and vim = v (0.5 / Q)
template <class T>
__device__ __forceinline__ cplx<T> phase_q(T v, T piq, T vim, T h_l, T w,
                                           T pp, T lgw) {
    cplx<T> vc = cmk(v * (T(1) + lgw / piq), vim);
    cplx<T> iv2 = cinv(cmul(vc, vc));
    return phase_of(cmk(iv2.re - pp, iv2.im), h_l, w);
}

template <class T>
__device__ __forceinline__ cplx<T> inv_u2(T lgw, T q) {
    T piq = T(PI_D) * q;
    cplx<T> u = cmk(T(1) + lgw / piq, T(0.5) / q);
    return cinv(cmul(u, u));
}

template <class T>
__device__ __forceinline__ mat4<T> sandwich(const mat4<T> &nt, cplx<T> e1,
                                            cplx<T> e2) {
    cplx<T> e12 = cmul(e1, e2);
    mat4<T> nb;
    nb.a11 = cmul(nt.a11, cmul(e1, e1));
    nb.a12 = cmul(nt.a12, e12);
    nb.a21 = cmul(nt.a21, e12);
    nb.a22 = cmul(nt.a22, cmul(e2, e2));
    return nb;
}

template <class T>
__device__ __forceinline__ mat4<T> columns(cplx<T> e1, cplx<T> e2,
                                           const mat4<T> &q) {
    mat4<T> r;
    r.a11 = cmul(e1, q.a11);
    r.a12 = cmul(e1, q.a12);
    r.a21 = cmul(e2, q.a21);
    r.a22 = cmul(e2, q.a22);
    return r;
}

// The recursion of one lane at angular frequency w through layers
// 0..depth of a staged chain: ``coef`` its coefficient rows (layer i at
// i * 32: rd, td, ru, tu, 8 values each), ``sc`` its scalars;
// phase_at(i, e1, e2) gives layer i's P and S phase terms.  Writes the
// lane's (cz, cr) for incidence WAVE at ``out``.  SUPPRESS: the direct
// downward transmission g = prod_i e_i tu_{i+1}, no reverberations
// (rf.py step_suppress, :445-455).
template <int WAVE, bool SUPPRESS, class T, class Phase>
__device__ __forceinline__ void transmit(
        const T *coef, const T *sc, T w, int depth, const Phase &phase_at,
        size_t out, T *__restrict__ czr, T *__restrict__ czi,
        T *__restrict__ crr, T *__restrict__ cri) {
    cplx<T> e1, e2;
    phase_at(0, e1, e2);
    mat4<T> g;
    if constexpr (SUPPRESS) {
        g = columns(e1, e2, lds_m4(coef + 24));
        for (int i = 1; i <= depth; ++i) {
            phase_at(i, e1, e2);
            g = m4mul(g, columns(e1, e2, lds_m4(coef + i * 32 + 24)));
        }
    } else {
        // layer 0: free surface on top
        mat4<T> nb = sandwich(m4_of(sc + SC_NT), e1, e2);
        mat4<T> q = m4mul(m4inv_of_eye_minus(m4mul(lds_m4(coef), nb)),
                          lds_m4(coef + 24));
        g = columns(e1, e2, q);
        mat4<T> x = m4mul(nb, q);
        for (int i = 1; i <= depth; ++i) {
            phase_at(i, e1, e2);
            const T *prev = coef + (i - 1) * 32;  // ru, td of i - 1
            const T *cur = coef + i * 32;
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
    mat4<T> t_full = m4mul(m4_of(sc + SC_HMAT), g);
    cplx<T> cr = cscale(T(2), WAVE == 0 ? t_full.a11 : t_full.a12);
    cplx<T> cz = cscale(T(2), WAVE == 0 ? t_full.a21 : t_full.a22);
    T wt0 = w * sc[SC_T0];
    cplx<T> qq = cmk(mcos(wt0), msin(wt0));
    cz = cmul(cz, qq);
    cr = cmul(cr, qq);
    czr[out] = cz.re;
    czi[out] = cz.im;
    crr[out] = cr.re;
    cri[out] = cr.im;
}

// Shared-memory record of chain cc of the tile, ``cs`` values of the
// scalar type T from sm + cc * cs (ops/resp.py geometry mirrors it):
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
// the skip depth).  T is float, or double for K3's float64 instances.
template <class T, int WAVE, bool QMODE, int OPT>
__global__ void __launch_bounds__(RESP_MAX_THREADS, resp_min_blocks<T>())
resp_kernel(const T *__restrict__ coefs, const T *__restrict__ pack,
            const T *__restrict__ qp, const T *__restrict__ qs,
            PackLayout lay, int nl, int C, int F, int nfreq, T dw, T wref,
            int tile, int cs, T *__restrict__ czr, T *__restrict__ czi,
            T *__restrict__ crr, T *__restrict__ cri) {
    constexpr int NK = QMODE ? 7 : 3;
    constexpr bool SUPPRESS = (OPT & 1) != 0;
    constexpr bool ELASTIC = (OPT & 2) != 0;
    extern __shared__ float4 smem4[];
    T *sm = reinterpret_cast<T *>(smem4);
    int *s_rows = reinterpret_cast<int *>(sm + tile * cs);  // staged rows
    const int NT = blockDim.x;
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
    for (int i = tid; i < NROW * tc; i += NT) {
        int k = i / tc, cc = i - k * tc;
        T *sc = rec(cc) + s_off;
        if (k == 0) {
            T p = P(lay.p, cc);
            sc[SC_P] = p;
            sc[SC_PP] = p * p;
        } else if (k == 1) {
            sc[SC_T0] = P(lay.t0, cc);
        } else if (k == 2) {
            *depth_slot(sc) = (int)P(lay.depth, cc);
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
        for (int i = tid; i < (nl - 1) * tc; i += NT) {
            int l = i / tc, cc = i - l * tc;
            const T *a = qp + (size_t)l * C + c_base + cc;
            const T *b = qs + (size_t)l * C + c_base + cc;
            if (__ldg(a) != __ldg(a + C) || __ldg(b) != __ldg(b + C))
                atomicMax(depth_slot(rec(cc) + s_off), l);
        }
        __syncthreads();
    }
    for (int cc = tid; cc < tc; cc += NT) {
        int *d = depth_slot(rec(cc) + s_off);
        *d = min(*d, nl - 2);
        atomicMax(s_rows, (*d + 1) * 32);
    }
    __syncthreads();

    // per-layer terms of layers 0..depth, then the coefficient rows
    for (int i = tid; i < nl * tc; i += NT) {
        int l = i / tc, cc = i - l * tc;
        T *r = rec(cc);
        if (l > depth_of(r + s_off)) continue;
        T *kp = r + k_off + l;
        T vp = P(lay.vp + l, cc), vs = P(lay.vs + l, cc);
        kp[0] = P(lay.h + l, cc);
        if constexpr (QMODE && !ELASTIC) {
            T qpl = __ldg(qp + (size_t)l * C + c_base + cc);
            T qsl = __ldg(qs + (size_t)l * C + c_base + cc);
            kp[nl] = vp;
            kp[2 * nl] = vs;
            kp[3 * nl] = T(PI_D) * qpl;
            kp[4 * nl] = vp * (T(0.5) / qpl);
            kp[5 * nl] = T(PI_D) * qsl;
            kp[6 * nl] = vs * (T(0.5) / qsl);
        } else {
            kp[nl] = T(1) / (vp * vp);
            kp[2 * nl] = T(1) / (vs * vs);
        }
    }
    const int rows = *s_rows;
    for (int i = tid; i < rows * tc; i += NT) {
        int row = i / tc, cc = i - row * tc;
        T *r = rec(cc);
        int depth = depth_of(r + s_off);
        if (row < (depth + 1) * 32)
            r[row] = __ldg(coefs + (size_t)row * C + c_base + cc);
    }
    __syncthreads();

    for (int j = tid; j < tc * F; j += NT) {
        const int cc = j / F;
        const int f = j - cc * F;
        const T *r = rec(cc);
        const T *kt = r + k_off;
        const T *sc = r + s_off;
        const int depth = depth_of(sc);
        const T pp = sc[SC_PP];
        const size_t out = (size_t)c_base * F + j;
        T jf = (T)min(f, nfreq - 1);
        T w = dw * jf;
        T lgw = jf > T(0) ? mlog(mmax(w, T(1e-30)) / wref) : T(0);
        if constexpr (ELASTIC) {
            auto phase_at = [&](int i, cplx<T> &e1, cplx<T> &e2) {
                T h_l = kt[i];
                e1 = phase_of(cmk(kt[nl + i] - pp, T(0)), h_l, w);
                e2 = phase_of(cmk(kt[2 * nl + i] - pp, T(0)), h_l, w);
            };
            transmit<WAVE, SUPPRESS>(r, sc, w, depth, phase_at, out, czr,
                                     czi, crr, cri);
        } else if constexpr (QMODE) {
            auto phase_at = [&](int i, cplx<T> &e1, cplx<T> &e2) {
                T h_l = kt[i];
                e1 = phase_q(kt[nl + i], kt[3 * nl + i], kt[4 * nl + i], h_l,
                             w, pp, lgw);
                e2 = phase_q(kt[2 * nl + i], kt[5 * nl + i], kt[6 * nl + i],
                             h_l, w, pp, lgw);
            };
            transmit<WAVE, SUPPRESS>(r, sc, w, depth, phase_at, out, czr,
                                     czi, crr, cri);
        } else {
            cplx<T> iu2_p = inv_u2(lgw, T(QP));
            cplx<T> iu2_s = inv_u2(lgw, T(QS));
            auto phase_at = [&](int i, cplx<T> &e1, cplx<T> &e2) {
                T h_l = kt[i];
                e1 = phase(kt[nl + i], h_l, w, pp, iu2_p);
                e2 = phase(kt[2 * nl + i], h_l, w, pp, iu2_s);
            };
            transmit<WAVE, SUPPRESS>(r, sc, w, depth, phase_at, out, czr,
                                     czi, crr, cri);
        }
    }
}

template <class T, int WAVE, bool QMODE, int OPT>
int launch(const T *coefs, const T *pack, const T *qp, const T *qs,
           PackLayout lay, int nl, int C, int F, int nsamp, T dw, T wref,
           int threads, int tile, int cs, int smem, T *czr, T *czi, T *crr,
           T *cri, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            resp_kernel<T, WAVE, QMODE, OPT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    int blocks = (C + tile - 1) / tile;
    resp_kernel<T, WAVE, QMODE, OPT><<<blocks, threads, smem, stream>>>(
        coefs, pack, qp, qs, lay, nl, C, F, nsamp / 2 + 1, dw, wref, tile,
        cs, czr, czi, crr, cri);
    return (int)cudaGetLastError();
}

template <class T>
using Launch = int (*)(const T *, const T *, const T *, const T *,
                       PackLayout, int, int, int, int, T, T, int, int, int,
                       int, T *, T *, T *, T *, cudaStream_t);

// the instance of incidence ``wave`` and options bitmask ``options``
template <class T, bool QMODE>
Launch<T> arm(int wave, int options) {
    static const Launch<T> table[8] = {
        launch<T, 0, QMODE, 0>, launch<T, 0, QMODE, 1>,
        launch<T, 0, QMODE, 2>, launch<T, 0, QMODE, 3>,
        launch<T, 1, QMODE, 0>, launch<T, 1, QMODE, 1>,
        launch<T, 1, QMODE, 2>, launch<T, 1, QMODE, 3>};
    return table[wave * 4 + options];
}

// ``elem``: the bytes of the scalar type
int check_geometry(int nl, int threads, int tile, int cs, int smem, int nk,
                   int elem) {
    if (threads < 32 || threads > RESP_MAX_THREADS || threads % 32 != 0
        || tile < 1 || nl < 2 || cs % 4 != 0
        || cs < (nl - 1) * 32 + nk * nl + N_SC
        || smem < tile * cs * elem + 4)
        return (int)cudaErrorInvalidConfiguration;
    return 0;
}

}  // namespace

// threads, tile, the chain record's values cs and smem come from
// ops/resp.py geometry; options is the bitmask of rf.py
// SUPPRESS_MULTIPLES (1) and WITHOUT_ANELASTICITY (2)
extern "C" int bh_resp(const float *coefs, const float *pack,
                       PackLayout lay, int nl, int C, int F, int nsamp,
                       int wave, int options, float dw, int threads,
                       int tile, int cs, int smem, float *czr, float *czi,
                       float *crr, float *cri, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (options < 0 || options > 3) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, cs, smem, 3, 4)) return e;
    if ((long)C * F == 0) return 0;
    return arm<float, false>(wave, options)(
        coefs, pack, nullptr, nullptr, lay, nl, C, F, nsamp, dw, (float)WREF,
        threads, tile, cs, smem, czr, czi, crr, cri, stream);
}

// K3 in double: the same kernel at the scalar type double
extern "C" int bh_resp_f64(const double *coefs, const double *pack,
                           PackLayout lay, int nl, int C, int F, int nsamp,
                           int wave, int options, double dw, int threads,
                           int tile, int cs, int smem, double *czr,
                           double *czi, double *crr, double *cri,
                           cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (options < 0 || options > 3) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, cs, smem, 3, 8)) return e;
    if ((long)C * F == 0) return 0;
    return arm<double, false>(wave, options)(
        coefs, pack, nullptr, nullptr, lay, nl, C, F, nsamp, dw, WREF,
        threads, tile, cs, smem, czr, czi, crr, cri, stream);
}

extern "C" int bh_resp_q(const float *coefs, const float *pack,
                         const float *qp, const float *qs, PackLayout lay,
                         int nl, int C, int F, int nsamp, int wave,
                         int options, float dw, float wref, int threads,
                         int tile, int cs, int smem, float *czr, float *czi,
                         float *crr, float *cri, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (options < 0 || options > 3) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, cs, smem, 7, 4)) return e;
    if ((long)C * F == 0) return 0;
    return arm<float, true>(wave, options)(coefs, pack, qp, qs, lay, nl, C,
                                           F, nsamp, dw, wref, threads, tile,
                                           cs, smem, czr, czi, crr, cri,
                                           stream);
}
