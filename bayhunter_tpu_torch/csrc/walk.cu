// K2: warm root walker, Rayleigh or Love, one thread per (chain, period)
// lane.
//
// Replaces the TPU kernel bayhunter_tpu/ops/pallas_walk.py:71
// (_walk_kernel, driven by warm_roots_walk :396).  Plain twin:
// bayhunter_tpu_torch/ops/walk.py warm_roots_walk_plain.
//
// Each thread recentres its warm start with Newton passes, walks
// candidates +1, -1, +2, -2, ... DDC from it until a sign change
// brackets the root or both sides leave [cm, bx + DDC], bisects the
// bracket nbisect times and closes with a secant; it exits as soon as
// it has found its root or died (the TPU kernel's block-wide exit gives
// the same per-lane result).  Each chain uses its own deepest layer
// ``top``.  Both wave types read the model kernel's Rayleigh planes
// [d; a; b; rho]: on a flat earth Love's [d; b; rho] are planes 0, 2
// and 3 of that stack (pallas_prep._swd_rows builds the same d, b and
// rho for both), and so are cm, betmx and top.  A spherical-earth Love
// target would need its own density plane (exponent -5 against the
// Rayleigh -2.275, pallas_prep.py:285).
//
// Bound on the card: transcendental arithmetic — every secular
// evaluation runs sqrt/sin/cos/exp and ~150 flops per layer (Love: one
// sqrt, sin/cos or exp and ~25 flops), a few to ~40 evaluations per lane; operands are a few hundred bytes per chain,
// read through the read-only cache.  Left for later work: lanes of one
// warp diverge in their walk length (threads of a finished lane idle
// until the warp's slowest lane ends), layer planes are re-read from
// L1/L2 for every evaluation instead of being staged in shared memory,
// and float32 transcendentals run without --use_fast_math.
#include <cuda_runtime.h>

#include "secular.cuh"

namespace {

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

template <int IWAVE>
__global__ void walk_kernel(const float *__restrict__ props,
                            const float *__restrict__ omegas,
                            const float *__restrict__ c_prev,
                            const float *__restrict__ cm_in,
                            const float *__restrict__ bx_in,
                            const float *__restrict__ top_in,
                            const float *__restrict__ slope_prev, int nl,
                            int C, int R, int max_steps, int nbisect,
                            int newton_iters, float maxshift, int has_slope,
                            float *__restrict__ c_out,
                            bool *__restrict__ found_out,
                            float *__restrict__ slope_out) {
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (long)C * R) return;
    int c = (int)(lane / R);
    int r = (int)(lane % R);

    ChainLayers L;
    L.d = props;
    L.a = props + (size_t)nl * C;
    L.b = props + (size_t)2 * nl * C;
    L.rho = props + (size_t)3 * nl * C;
    L.off = c;
    L.stride = C;
    L.nl = nl;
    L.top = min((int)top_in[c], nl - 2);
    L.water = L.at(L.b, 0) <= 0.0f;

    const float dc = 0.005f;
    const float eps = dc / 16.0f;
    float omega = fmaxf(omegas[r], 1.0e-4f);
    float cm = cm_in[c];
    float bx = bx_in[c];
    float c0 = clipf(c_prev[lane], cm, bx);
    auto sec = [&](float cand) {
        return L.secular<IWAVE>(omega / cand, omega);
    };

    if (newton_iters > 0) {
        float v0 = sec(c0);
        float hasf, slope;
        if (has_slope) {
            float sl = slope_prev[lane];
            hasf = fabsf(sl) > 0.0f ? 1.0f : 0.0f;
            slope = hasf > 0.5f ? sl : 1.0f;
        } else {
            hasf = 1.0f;
            slope = (sec(c0 + eps) - v0) / eps;
            if (slope == 0.0f) slope = 1.0f;
        }
        float shift = clipf(-v0 / slope, -maxshift, maxshift) * hasf;
        float c_pv = c0, v_pv = v0;
        c0 = clipf(c0 + shift, cm, bx);
        for (int it = 1; it < newton_iters; ++it) {
            v0 = sec(c0);
            float step = c0 - c_pv;
            float sec = (v0 - v_pv) / (step == 0.0f ? 1.0f : step);
            if (fabsf(step) > eps) slope = sec;
            if (slope == 0.0f) slope = 1.0f;
            shift = clipf(-v0 / slope, -maxshift, maxshift) * hasf;
            c_pv = c0;
            v_pv = v0;
            c0 = clipf(c0 + shift, cm, bx);
        }
    }

    float f0 = sec(c0);
    bool s_r = f0 > 0.0f, s_l = s_r;
    float f_r = f0, f_l = f0;
    bool found = false;
    float lo = cm, hi = cm + dc, f_lo = f0, f_hi = f0;
    for (int t = 0; t < max_steps; ++t) {
        float k = (float)(t / 2 + 1) * dc;
        bool right = (t % 2) == 0;
        float cand = right ? c0 + k : c0 - k;
        bool valid = right ? cand <= bx + dc : cand >= cm;
        float f = sec(cand);
        bool s = f > 0.0f;
        bool s_prev = right ? s_r : s_l;
        float f_prev = right ? f_r : f_l;
        if (s != s_prev && valid) {
            lo = right ? cand - dc : cand;
            hi = right ? cand : cand + dc;
            f_lo = right ? f_prev : f;
            f_hi = right ? f : f_prev;
            found = true;
            break;
        }
        if (valid) {
            if (right) {
                s_r = s;
                f_r = f;
            } else {
                s_l = s;
                f_l = f;
            }
        }
        if (!right && (c0 + k) > bx + dc && (c0 - k) < cm) break;  // dead
    }
    if (found) {
        for (int i = 0; i < nbisect; ++i) {
            float mid = 0.5f * (lo + hi);
            float fm = sec(mid);
            if ((fm > 0.0f) == (f_lo > 0.0f)) {
                lo = mid;
                f_lo = fm;
            } else {
                hi = mid;
                f_hi = fm;
            }
        }
    }
    float denom = f_hi - f_lo;
    if (denom == 0.0f) denom = 1.0f;
    float cs = lo - f_lo * (hi - lo) / denom;
    float edge = fabsf(f_lo) <= fabsf(f_hi) ? lo : hi;
    bool good = cs > lo && cs < hi && isfinite(cs);
    float width = hi - lo;
    float slope = (f_hi - f_lo) / (width == 0.0f ? 1.0f : width);
    c_out[lane] = good ? cs : edge;
    found_out[lane] = found;
    slope_out[lane] = found ? slope : 0.0f;
}

}  // namespace

extern "C" int bh_walk(const float *props, const float *omegas,
                       const float *c_prev, const float *cm, const float *bx,
                       const float *top, const float *slope_prev, int nl,
                       int C, int R, int max_steps, int nbisect,
                       int newton_iters, float maxshift, int has_slope,
                       int iwave, float *c_out, bool *found_out,
                       float *slope_out, cudaStream_t stream) {
    if (iwave != 1 && iwave != 2) return (int)cudaErrorInvalidValue;
    long n = (long)C * R;
    if (n == 0) return 0;
    int threads = 128;
    int blocks = (int)((n + threads - 1) / threads);
    if (iwave == 1)
        walk_kernel<1><<<blocks, threads, 0, stream>>>(
            props, omegas, c_prev, cm, bx, top, slope_prev, nl, C, R,
            max_steps, nbisect, newton_iters, maxshift, has_slope, c_out,
            found_out, slope_out);
    else
        walk_kernel<2><<<blocks, threads, 0, stream>>>(
            props, omegas, c_prev, cm, bx, top, slope_prev, nl, C, R,
            max_steps, nbisect, newton_iters, maxshift, has_slope, c_out,
            found_out, slope_out);
    return (int)cudaGetLastError();
}
