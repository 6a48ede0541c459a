// K4 / K5: Rayleigh and Love secular values of candidate phase
// velocities, on tiles of whole chains.
//
// Replace the TPU kernels bayhunter_tpu/ops/pallas_secular.py:267
// (_dltar4_kernel, drivers dltar4_pallas :472 and dltar4_pallas_single
// :449) and :332 (_dltar1_kernel, drivers dltar1_pallas :406 and
// dltar1_pallas_single :385).  Plain twins:
// bayhunter_tpu_torch/ops/swd.py dltar4 and dltar1 at the wavenumbers
// omega / c.
//
// The candidates are a (C, R, K) grid: chain, period, candidate.  The
// phase velocities c and the angular frequencies omega come with their
// strides, so a grid that the caller broadcasts (the counting search's
// (C, 1, K) velocities, the (R,) frequencies) is read where it lies and
// never copied; omega does not vary along K.  The layer arrays d, a, b,
// rho are (C, NL) rows with the halfspace last; the result is (C, R, K)
// row-major.  Each chain runs its recursion from its own deepest layer
// with thickness, ``top``, up (the TPU kernel ran its chain tile's
// deepest layer; the skipped slots are identities up to a positive
// scale, so signs do not change).
//
// Bound on the card: the float32 instruction stream — per candidate
// and layer, Rayleigh runs two square roots, two sin/cos or exp pairs,
// one exp, seven IEEE divisions (four by rho, two in the eigenfunction
// terms, one by the norm) and ~150 flops, Love one square root, one
// sin/cos or exp, four divisions and ~25 flops, all unfused and
// full-precision (--fmad=false), which
// bitwise parity with the twins needs; a candidate moves 8 bytes or
// fewer.  The design:
//   * a block takes a tile of whole chains (ops/swd.py geometry sizes
//     it) and stages their layer rows and angular frequencies in shared
//     memory with loads coalesced across the tile (a tile's rows are
//     one contiguous run of each array);
//   * one warp finds a chain's ``top`` by a vote over its thicknesses;
//   * the candidate-invariant terms — Rayleigh's omega / a, omega / b
//     and gammk of every applied layer, the halfspace and the water
//     clause; Love's omega / b_safe and mu of every applied layer and
//     the halfspace's omega / b and 1 / b^2 — are computed once per
//     (chain, period, layer) into shared memory with the expressions of
//     the one-shot functions in secular.cuh, so no rounding changes;
//   * the threads then form wvno = omega / c (the IEEE division torch's
//     twin makes) and run the *_at layer updates; a warp takes 32
//     candidates of one chain (a warp-slot is a chain and a chunk of 32
//     of its R * K candidates), so its lanes share a layer count, and
//     the tile size makes the warp-slots fill the block's warps.
// Left for later: the divisions inside the layer update and the
// accurate sin/cos stay, which parity needs; lanes in the propagating
// and the evanescent regime of one layer take both branches.
#include <cuda_runtime.h>

#include "secular.cuh"

namespace {

constexpr int SECULAR_MAX_THREADS = 256;  // ops/swd.py MAX_THREADS

// Shared floats per chain of a tile (ops/swd.py chain_floats): the
// layer rows [d; a (Love: mu); b; rho], the R angular frequencies,
// then the invariant terms [slot][term][period] of slots 0..nl-2 and
// the halfspace in slot nl-1 (Rayleigh: xka, xkb, gammk; Love: xkb,
// with 1 / b_hs^2 in the mu row's halfspace slot).  Then one int per
// chain: its top.
__host__ __device__ int rayleigh_floats(int nl, int R) { return 4 * nl + R + 3 * R * nl; }
__host__ __device__ int love_floats(int nl, int R) { return 4 * nl + R + R * nl; }

template <class T, int IWAVE>
__global__ void __launch_bounds__(SECULAR_MAX_THREADS)
secular_kernel(const T *__restrict__ c, int sc_c, int sc_r, int sc_k,
               const T *__restrict__ omega, int so_c, int so_r,
               const T *__restrict__ d, const T *__restrict__ a,
               const T *__restrict__ b, const T *__restrict__ rho,
               int nl, int C, int R, int K, int tile,
               T *__restrict__ out) {
    constexpr int NINV = IWAVE == 2 ? 3 : 1;
    extern __shared__ double smem_d[];
    T *smem = reinterpret_cast<T *>(smem_d);
    const int F = IWAVE == 2 ? rayleigh_floats(nl, R) : love_floats(nl, R);
    const int NT = blockDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nw = NT >> 5;
    const int c_base = blockIdx.x * tile;
    const int tc = min(tile, C - c_base);
    int *s_top = (int *)(smem + tile * F);
    const int OM = 4 * nl;          // a chain's angular frequencies
    const int INV = OM + R;         // its invariant terms
    const int hs = nl - 1;

    // the tile's layer rows and angular frequencies
    for (int i = tid; i < tc * nl; i += NT) {
        const int cc = i / nl, l = i - cc * nl;
        const size_t g = (size_t)c_base * nl + i;
        T *row = smem + cc * F;
        row[l] = __ldg(d + g);
        if constexpr (IWAVE == 2) row[nl + l] = __ldg(a + g);
        row[2 * nl + l] = __ldg(b + g);
        row[3 * nl + l] = __ldg(rho + g);
    }
    for (int i = tid; i < tc * R; i += NT) {
        const int cc = i / R, r = i - cc * R;
        smem[cc * F + OM + r] = __ldg(omega + (size_t)(c_base + cc) * so_c
                                      + (size_t)r * so_r);
    }
    __syncthreads();

    // each chain's top, the deepest slot 0..nl-2 with d > 0 (-1 for a
    // pure halfspace), by one warp's vote
    for (int cc = warp; cc < tc; cc += nw) {
        const T *row = smem + cc * F;
        int top = -1;
        for (int l0 = 0; l0 < nl - 1; l0 += 32) {
            const int l = l0 + lane;
            const unsigned v = __ballot_sync(0xffffffffu,
                                             l < nl - 1 && row[l] > T(0));
            if (v) top = l0 + 31 - __clz(v);
        }
        if (lane == 0) s_top[cc] = top;
    }
    __syncthreads();

    // the invariant terms of slots 0..max(top, 0) (slot 0's xka closes
    // Rayleigh's water clause) and of the halfspace, slot-major so that
    // a warp skips the unused slots together
    for (int i = tid; i < nl * tc * R; i += NT) {
        const int l = i / (tc * R);
        const int j = i - l * tc * R;
        const int cc = j / R, r = j - cc * R;
        if (l > max(s_top[cc], 0) && l != hs) continue;
        T *row = smem + cc * F;
        T *inv = row + INV;
        const T om = mmax(row[OM + r], T(1.0e-4));
        if constexpr (IWAVE == 2) {
            const dunkin_inv_t<T> v = dltar4_invariants(om, row[nl + l],
                                                        row[2 * nl + l]);
            inv[(l * NINV + 0) * R + r] = v.xka;
            inv[(l * NINV + 1) * R + r] = v.xkb;
            inv[(l * NINV + 2) * R + r] = v.gammk;
        } else if (l == hs) {
            const T b_hs = row[2 * nl + l];
            inv[l * R + r] = om / b_hs;
            if (r == 0) row[nl + l] = T(1) / (b_hs * b_hs);
        } else {
            const T b_safe = love_b_safe(row[2 * nl + l]);
            inv[l * R + r] = om / b_safe;
            if (r == 0) row[nl + l] = love_xmu(row[3 * nl + l], b_safe);
        }
    }
    __syncthreads();

    // the candidates: warp-slot s is chain s / W, candidates
    // 32 (s % W) .. 32 (s % W) + 31 of its R * K
    const int E = R * K;
    const int W = (E + 31) >> 5;
    for (int s = warp; s < tc * W; s += nw) {
        const int cc = s / W;
        const int e = (s - cc * W) * 32 + lane;
        if (e >= E) continue;
        const int r = e / K, k = e - r * K;
        const int cg = c_base + cc;
        const T *row = smem + cc * F;
        const T *inv = row + INV;
        const T wvno = row[OM + r]
            / __ldg(c + (size_t)cg * sc_c + (size_t)r * sc_r
                    + (size_t)k * sc_k);
        const int top = s_top[cc];
        const int lstop = row[2 * nl] <= T(0) ? 1 : 0;   // water on top
        T f;
        if constexpr (IWAVE == 1) {
            evec2_t<T> e2 = dltar1_halfspace_at(wvno, inv[hs * R + r],
                                                row[3 * nl + hs],
                                                row[nl + hs]);
            for (int l = top; l >= lstop; --l)
                e2 = dltar1_layer_at(e2, wvno, row[l], inv[l * R + r],
                                     row[nl + l]);
            f = e2.e1;
        } else {
            const T wvno2 = wvno * wvno;
            dunkin_inv_t<T> v;
            v.xka = inv[(hs * NINV + 0) * R + r];
            v.xkb = inv[(hs * NINV + 1) * R + r];
            v.gammk = inv[(hs * NINV + 2) * R + r];
            evec_t<T> ev = dltar4_halfspace_at(wvno, wvno2, v,
                                               row[3 * nl + hs]);
            for (int l = top; l >= lstop; --l)
                ev = dltar4_layer_at(ev, wvno, wvno2, row[l],
                                     row[3 * nl + l],
                                     inv[(l * NINV + 0) * R + r],
                                     inv[(l * NINV + 1) * R + r],
                                     inv[(l * NINV + 2) * R + r]);
            f = lstop ? water_close(ev, wvno, inv[r], row[0], row[3 * nl])
                      : ev.e1;
        }
        out[((size_t)cg * R + r) * K + k] = f;
    }
}

// a launch above 48 KB of shared memory opts in to more
template <class T, int IWAVE>
cudaError_t opt_in(int smem) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            secular_kernel<T, IWAVE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

template <class T, int IWAVE>
int launch(const T *c, int sc_c, int sc_r, int sc_k, const T *omega,
           int so_c, int so_r, const T *d, const T *a, const T *b,
           const T *rho, int nl, int C, int R, int K, int threads, int tile,
           int smem, T *out, cudaStream_t stream) {
    const long floats = IWAVE == 2 ? rayleigh_floats(nl, R)
                                   : love_floats(nl, R);
    if (threads < 32 || threads > SECULAR_MAX_THREADS || threads % 32 != 0
        || tile < 1 || nl < 2 || R < 1 || K < 1
        || smem < (long)tile * (sizeof(T) * floats + 4))
        return (int)cudaErrorInvalidConfiguration;
    if (C == 0) return 0;
    cudaError_t e = opt_in<T, IWAVE>(smem);
    if (e != cudaSuccess) return (int)e;
    int blocks = (C + tile - 1) / tile;
    secular_kernel<T, IWAVE><<<blocks, threads, smem, stream>>>(
        c, sc_c, sc_r, sc_k, omega, so_c, so_r, d, a, b, rho, nl, C, R, K,
        tile, out);
    return (int)cudaGetLastError();
}

template <class T, int IWAVE>
int occupancy(int threads, int smem, int *blocks) {
    cudaError_t e = opt_in<T, IWAVE>(smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, secular_kernel<T, IWAVE>, threads, smem);
}

}  // namespace

// K4: Rayleigh.  threads, tile and smem come from ops/swd.py geometry;
// a shared-memory size below the tile's layout is refused
extern "C" int bh_secular4(const float *c, int sc_c, int sc_r, int sc_k,
                           const float *omega, int so_c, int so_r,
                           const float *d, const float *a, const float *b,
                           const float *rho, int nl, int C, int R, int K,
                           int threads, int tile, int smem, float *out,
                           cudaStream_t stream) {
    return launch<float, 2>(c, sc_c, sc_r, sc_k, omega, so_c, so_r, d, a, b,
                            rho, nl, C, R, K, threads, tile, smem, out,
                            stream);
}

// K5: Love (no P velocities)
extern "C" int bh_secular1(const float *c, int sc_c, int sc_r, int sc_k,
                           const float *omega, int so_c, int so_r,
                           const float *d, const float *b, const float *rho,
                           int nl, int C, int R, int K, int threads, int tile,
                           int smem, float *out, cudaStream_t stream) {
    return launch<float, 1>(c, sc_c, sc_r, sc_k, omega, so_c, so_r, d,
                            nullptr, b, rho, nl, C, R, K, threads, tile, smem,
                            out, stream);
}

// K4 and K5 in double: the same kernel at the scalar type double
extern "C" int bh_secular4_f64(const double *c, int sc_c, int sc_r, int sc_k,
                               const double *omega, int so_c, int so_r,
                               const double *d, const double *a,
                               const double *b, const double *rho, int nl,
                               int C, int R, int K, int threads, int tile,
                               int smem, double *out, cudaStream_t stream) {
    return launch<double, 2>(c, sc_c, sc_r, sc_k, omega, so_c, so_r, d, a, b,
                             rho, nl, C, R, K, threads, tile, smem, out,
                             stream);
}

extern "C" int bh_secular1_f64(const double *c, int sc_c, int sc_r, int sc_k,
                               const double *omega, int so_c, int so_r,
                               const double *d, const double *b,
                               const double *rho, int nl, int C, int R,
                               int K, int threads, int tile, int smem,
                               double *out, cudaStream_t stream) {
    return launch<double, 1>(c, sc_c, sc_r, sc_k, omega, so_c, so_r, d,
                             nullptr, b, rho, nl, C, R, K, threads, tile,
                             smem, out, stream);
}

// blocks of K4 (iwave 2) or K5 (iwave 1) that one SM holds at once at
// this block size and shared-memory size (the CUDA occupancy
// calculator: registers, shared memory, block limits)
extern "C" int bh_secular_occupancy(int iwave, int threads, int smem,
                                    int *blocks) {
    return iwave == 2 ? occupancy<float, 2>(threads, smem, blocks)
                      : occupancy<float, 1>(threads, smem, blocks);
}
