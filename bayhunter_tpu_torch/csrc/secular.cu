// K4 / K5: Rayleigh and Love secular values on a (chain, candidate)
// grid, one thread per element.
//
// Replace the TPU kernels bayhunter_tpu/ops/pallas_secular.py:267
// (_dltar4_kernel, drivers dltar4_pallas :472 and dltar4_pallas_single
// :449) and :332 (_dltar1_kernel, drivers dltar1_pallas :406 and
// dltar1_pallas_single :385).  Plain twins:
// bayhunter_tpu_torch/ops/swd.py dltar4 and dltar1.
//
// Candidates wvno and omega are (C, L) row-major, the layer arrays
// d, a, b, rho (C, NL) rows with the halfspace last; the result is
// (C, L).  Each thread finds its own chain's deepest layer with
// thickness and runs the recursion from there up (the TPU kernel ran
// its chain tile's deepest layer; the skipped slots are identities up
// to a positive scale, so signs do not change).  The grid covers the
// C * L elements exactly: no lane padding to 128 and no chain-tile
// padding.
//
// Bound on the card: transcendental arithmetic — per element and
// layer, Rayleigh runs two square roots, two sin/cos or exp pairs, one
// exp and ~150 flops, Love one square root, one sin/cos or exp and ~25
// flops, against 12 bytes of candidate traffic per element; a chain's
// layer rows (16 NL bytes) are shared by its L threads through L1.
// Left for later work: staging layer rows in shared memory, and warps
// that straddle two chains of different depths.
#include <cuda_runtime.h>

#include "secular.cuh"

namespace {

template <int IWAVE>
__global__ void secular_kernel(const float *__restrict__ wvno,
                               const float *__restrict__ omega,
                               const float *__restrict__ d,
                               const float *__restrict__ a,
                               const float *__restrict__ b,
                               const float *__restrict__ rho, int nl,
                               int C, int L, float *__restrict__ out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long)C * L) return;
    ChainLayers lay;
    lay.d = d;
    lay.a = a;
    lay.b = b;
    lay.rho = rho;
    lay.off = (size_t)(i / L) * nl;
    lay.stride = 1;
    lay.nl = nl;
    lay.top = lay.deepest();
    lay.water = lay.at(b, 0) <= 0.0f;
    out[i] = lay.secular<IWAVE>(wvno[i], fmaxf(omega[i], 1.0e-4f));
}

template <int IWAVE>
int launch(const float *wvno, const float *omega, const float *d,
           const float *a, const float *b, const float *rho, int nl,
           int C, int L, float *out, cudaStream_t stream) {
    if (nl < 2) return (int)cudaErrorInvalidValue;
    long n = (long)C * L;
    if (n == 0) return 0;
    int threads = 128;
    int blocks = (int)((n + threads - 1) / threads);
    secular_kernel<IWAVE><<<blocks, threads, 0, stream>>>(
        wvno, omega, d, a, b, rho, nl, C, L, out);
    return (int)cudaGetLastError();
}

}  // namespace

// K4: Rayleigh
extern "C" int bh_secular4(const float *wvno, const float *omega,
                           const float *d, const float *a, const float *b,
                           const float *rho, int nl, int C, int L,
                           float *out, cudaStream_t stream) {
    return launch<2>(wvno, omega, d, a, b, rho, nl, C, L, out, stream);
}

// K5: Love (no P velocities)
extern "C" int bh_secular1(const float *wvno, const float *omega,
                           const float *d, const float *b, const float *rho,
                           int nl, int C, int L, float *out,
                           cudaStream_t stream) {
    return launch<1>(wvno, omega, d, nullptr, b, rho, nl, C, L, out,
                     stream);
}
