// K2: warm root walker, Rayleigh or Love, one thread per (chain, period)
// lane.
//
// Replaces the TPU kernel bayhunter_tpu/ops/pallas_walk.py:71
// (_walk_kernel, driven by warm_roots_walk :396).  Plain twin:
// bayhunter_tpu_torch/ops/walk.py warm_roots_walk_plain.
//
// Each lane recentres its warm start with Newton passes, walks
// candidates +1, -1, +2, -2, ... DDC from it until a sign change
// brackets the root or both sides leave [cm, bx + DDC], bisects the
// bracket nbisect times and closes with a secant; it exits as soon as
// it has found its root or died (the TPU kernel's block-wide exit gives
// the same per-lane result).  Each chain uses its own deepest layer
// ``top``.  Both wave types read the model kernel's Rayleigh planes
// [d; a; b; rho]: on a flat earth Love's [d; b; rho] are planes 0, 2
// and 3 of that stack (pallas_prep._swd_rows builds the same d, b and
// rho for both), and so are cm, betmx and top.  On a spherical earth
// the flattened d, b, cm, betmx and top are again shared, but the
// density is not (exponent -5 for Love against the Rayleigh -2.275,
// pallas_prep.py:285): a spherical Love target passes K1's Love
// density plane as ``rho``, read in place of plane 3 (NULL: plane 3).
// A group-velocity target is two lanes per period, t / (1 +- 0.005),
// differenced on the host (ops/swd.py group_velocity); the kernel
// sees lanes only, so its group arm is the lane count (up to 120 at
// 60 periods, more rounds of a block's threads past 128) and the
// caller's 12 bisections.
//
// Bound on the card: the float32 instruction stream of the secular
// function — per layer and evaluation two square roots, two sin/cos or
// exp pairs, one exp, seven IEEE divisions and ~150 flops (Love: one
// square root, one sin/cos or exp, three divisions, ~25 flops), built
// with --fmad=false so that every root, found flag and slope equals the
// twin's bit for bit; a few to ~40 evaluations per lane; a few hundred
// operand bytes per chain.  The design:
//   * one evaluation site: a lane is a small state machine (Newton
//     start, finite-difference slope, Newton, walk start, walk, bisect,
//     done) around a single inlined secular call, so the recursion's
//     code exists once and a warp pays, per loop trip, for the lanes
//     still working;
//   * a block takes a tile of whole chains (``tile`` chains, all R
//     periods of each; the wrapper's walk.geometry sizes it) and stages
//     their top, cm, bx and layer slots 0..top plus the halfspace in
//     shared memory with loads coalesced across the tile's chains;
//   * each lane computes its frequency's candidate-invariant layer terms
//     (omega / a_l, omega / b_l, gammk; Love: omega / b_l, mu_l) once,
//     into its own shared-memory column, instead of once per candidate;
//   * the tile's chains are ordered by top (a rank sort in shared
//     memory), so that the lanes of a warp share a layer count; results
//     are written at each lane's own (chain, period) index.
// Left for later: lanes of one warp still differ in their walk
// lengths and the warp runs its longest, most of all on the z walks
// (chip_smoke.py prints the layer-evaluations executed per useful one
// with and without the layer counts; a warp-cooperative walk would
// evaluate candidates that no lane consumes); the divisions
// inside the layer update (by rho, by the norm, in the eigenfunction
// terms) and the transcendental functions stay full-precision and
// unfused, which parity with the twins needs.
#include <cuda_runtime.h>

#include "secular.cuh"

namespace {

constexpr int WALK_MAX_THREADS = 128;  // ops/walk.py MAX_THREADS

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// the lane's phases, in the order a lane passes through them
enum : int { NEWTON0, SLOPE_FD, NEWTON, WALK0, WALK, BISECT, DONE };

// Shared-memory layout of one block (floats, then ints), mirrored by
// ops/walk.py geometry:
//   planes  [4][nl][tile]     d, a, b, rho of the tile's chains
//   cm, bx  [tile] each
//   inv     [ninv][nl-1][T]   each thread's invariant layer terms
//   top     [tile] int, order [tile] int (chains sorted by top)
template <int IWAVE>
__global__ void __launch_bounds__(WALK_MAX_THREADS)
walk_kernel(const float *__restrict__ props,
            const float *__restrict__ rho_in,
            const float *__restrict__ omegas,
            const float *__restrict__ c_prev,
            const float *__restrict__ cm_in,
            const float *__restrict__ bx_in,
            const float *__restrict__ top_in,
            const float *__restrict__ slope_prev, int nl, int C, int R,
            int max_steps, int nbisect, int newton_iters, float maxshift,
            int has_slope, int tile, float *__restrict__ c_out,
            bool *__restrict__ found_out, float *__restrict__ slope_out) {
    constexpr int NINV = IWAVE == 2 ? 3 : 2;
    extern __shared__ float smem[];
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int c_base = blockIdx.x * tile;
    const int tc = min(tile, C - c_base);
    float *s_plane = smem;                                  // [4][nl][tile]
    float *s_cm = s_plane + 4 * nl * tile;
    float *s_bx = s_cm + tile;
    float *s_inv = s_bx + tile;                             // [NINV][nl-1][T]
    int *s_top = (int *)(s_inv + NINV * (nl - 1) * T);
    int *s_order = s_top + tile;

    for (int cc = tid; cc < tc; cc += T) {
        int c = c_base + cc;
        s_top[cc] = min((int)top_in[c], nl - 2);
        s_cm[cc] = cm_in[c];
        s_bx[cc] = bx_in[c];
    }
    __syncthreads();
    // chain cc's rank by (top, cc): a stable sort of the tile
    for (int cc = tid; cc < tc; cc += T) {
        int key = s_top[cc], rank = 0;
        for (int k = 0; k < tc; ++k) {
            int tk = s_top[k];
            rank += tk < key || (tk == key && k < cc);
        }
        s_order[rank] = cc;
    }
    // slots 0..max(top, 0) (slot 0 holds the water test) and the
    // halfspace; consecutive threads read consecutive chains
    for (int p = 0; p < 4; ++p) {
        if (IWAVE == 1 && p == 1) continue;   // Love reads no P velocity
        const float *plane = (p == 3 && rho_in != nullptr ? rho_in
                              : props + (size_t)p * nl * C) + c_base;
        for (int i = tid; i < nl * tc; i += T) {
            int l = i / tc, cc = i - l * tc;
            if (l <= max(s_top[cc], 0) || l == nl - 1)
                s_plane[(p * nl + l) * tile + cc] =
                    __ldg(plane + (size_t)l * C + cc);
        }
    }
    __syncthreads();

    const float dc = 0.005f;
    const float eps = dc / 16.0f;
    float *inv = s_inv + tid;       // this thread's column, stride T
    auto plane = [&](int p, int l, int cc) {
        return s_plane[(p * nl + l) * tile + cc];
    };

    for (int j = tid; j < tc * R; j += T) {
        const int cc = s_order[j / R];
        const int r = j - (j / R) * R;
        const long lane = (long)(c_base + cc) * R + r;
        const int top = s_top[cc];
        const bool water = plane(2, 0, cc) <= 0.0f;
        const int lstop = water ? 1 : 0;
        const float omega = fmaxf(__ldg(omegas + r), 1.0e-4f);
        const float cm = s_cm[cc];
        const float bx = s_bx[cc];

        // candidate-invariant terms: the halfspace's and the water
        // clause's in registers, layer l's in this thread's column
        const int hs = nl - 1;
        const float rho_hs = plane(3, hs, cc);
        dunkin_inv hs4;
        float hs1_xkb = 0.0f, hs1_e2 = 0.0f, xka0 = 0.0f;
        if constexpr (IWAVE == 2) {
            hs4 = dltar4_invariants(omega, plane(1, hs, cc), plane(2, hs, cc));
            if (water) xka0 = omega / plane(1, 0, cc);
            for (int l = lstop; l <= top; ++l) {
                dunkin_inv v = dltar4_invariants(omega, plane(1, l, cc),
                                                 plane(2, l, cc));
                inv[(0 * (nl - 1) + l) * T] = v.xka;
                inv[(1 * (nl - 1) + l) * T] = v.xkb;
                inv[(2 * (nl - 1) + l) * T] = v.gammk;
            }
        } else {
            float b_hs = plane(2, hs, cc);
            hs1_xkb = omega / b_hs;
            hs1_e2 = 1.0f / (b_hs * b_hs);
            for (int l = lstop; l <= top; ++l) {
                float b_safe = love_b_safe(plane(2, l, cc));
                inv[(0 * (nl - 1) + l) * T] = omega / b_safe;
                inv[(1 * (nl - 1) + l) * T] = love_xmu(plane(3, l, cc),
                                                       b_safe);
            }
        }

        // the lane's state
        float c0 = clipf(c_prev[lane], cm, bx);
        int phase = newton_iters > 0 ? NEWTON0 : WALK0;
        float cand = c0;
        float v0 = 0.0f, hasf = 1.0f, slope = 1.0f, c_pv = 0.0f, v_pv = 0.0f;
        int it = 0, t = 0, nb = 0;
        bool s_r = false, s_l = false, found = false;
        float f_r = 0.0f, f_l = 0.0f;
        float lo = cm, hi = cm + dc, f_lo = 0.0f, f_hi = 0.0f;

        // one Newton shift from (v0, slope); then the next pass or the
        // walk start
        auto newton_shift = [&]() {
            float shift = clipf(-v0 / slope, -maxshift, maxshift) * hasf;
            c_pv = c0;
            v_pv = v0;
            c0 = clipf(c0 + shift, cm, bx);
            ++it;
            phase = it < newton_iters ? NEWTON : WALK0;
            cand = c0;
        };
        auto walk_cand = [&](int tt) {
            float k = (float)(tt / 2 + 1) * dc;
            return (tt % 2) == 0 ? c0 + k : c0 - k;
        };

        while (phase != DONE) {
            // the evaluation site
            const float wvno = omega / cand;
            float f;
            if constexpr (IWAVE == 1) {
                evec2 e = dltar1_halfspace_at(wvno, hs1_xkb, rho_hs, hs1_e2);
                for (int l = top; l >= lstop; --l)
                    e = dltar1_layer_at(e, wvno, plane(0, l, cc),
                                        inv[(0 * (nl - 1) + l) * T],
                                        inv[(1 * (nl - 1) + l) * T]);
                f = e.e1;
            } else {
                const float wvno2 = wvno * wvno;
                evec e = dltar4_halfspace_at(wvno, wvno2, hs4, rho_hs);
                for (int l = top; l >= lstop; --l)
                    e = dltar4_layer_at(e, wvno, wvno2, plane(0, l, cc),
                                        plane(3, l, cc),
                                        inv[(0 * (nl - 1) + l) * T],
                                        inv[(1 * (nl - 1) + l) * T],
                                        inv[(2 * (nl - 1) + l) * T]);
                f = water ? water_close(e, wvno, xka0, plane(0, 0, cc),
                                        plane(3, 0, cc))
                          : e.e1;
            }

            // absorb the value and pick the next candidate
            if (phase == NEWTON0) {
                v0 = f;
                if (has_slope) {
                    float sl = slope_prev[lane];
                    hasf = fabsf(sl) > 0.0f ? 1.0f : 0.0f;
                    slope = hasf > 0.5f ? sl : 1.0f;
                    newton_shift();
                } else {
                    hasf = 1.0f;
                    phase = SLOPE_FD;
                    cand = c0 + eps;
                }
            } else if (phase == SLOPE_FD) {
                slope = (f - v0) / eps;
                if (slope == 0.0f) slope = 1.0f;
                newton_shift();
            } else if (phase == NEWTON) {
                v0 = f;
                float step = c0 - c_pv;
                float secant = (v0 - v_pv) / (step == 0.0f ? 1.0f : step);
                if (fabsf(step) > eps) slope = secant;
                if (slope == 0.0f) slope = 1.0f;
                newton_shift();
            } else if (phase == WALK0) {
                s_r = s_l = f > 0.0f;
                f_r = f_l = f;
                f_lo = f_hi = f;
                t = 0;
                phase = max_steps > 0 ? WALK : DONE;
                cand = walk_cand(0);
            } else if (phase == WALK) {
                float k = (float)(t / 2 + 1) * dc;
                bool right = (t % 2) == 0;
                bool valid = right ? cand <= bx + dc : cand >= cm;
                bool s = f > 0.0f;
                bool s_prev = right ? s_r : s_l;
                float f_prev = right ? f_r : f_l;
                if (s != s_prev && valid) {
                    lo = right ? cand - dc : cand;
                    hi = right ? cand : cand + dc;
                    f_lo = right ? f_prev : f;
                    f_hi = right ? f : f_prev;
                    found = true;
                    phase = nbisect > 0 ? BISECT : DONE;
                    cand = 0.5f * (lo + hi);
                } else {
                    if (valid) {
                        if (right) {
                            s_r = s;
                            f_r = f;
                        } else {
                            s_l = s;
                            f_l = f;
                        }
                    }
                    ++t;
                    if ((!right && (c0 + k) > bx + dc && (c0 - k) < cm)
                        || t >= max_steps)
                        phase = DONE;                       // dead or capped
                    else
                        cand = walk_cand(t);
                }
            } else {                                        // BISECT
                if ((f > 0.0f) == (f_lo > 0.0f)) {
                    lo = cand;
                    f_lo = f;
                } else {
                    hi = cand;
                    f_hi = f;
                }
                ++nb;
                phase = nb < nbisect ? BISECT : DONE;
                cand = 0.5f * (lo + hi);
            }
        }

        float denom = f_hi - f_lo;
        if (denom == 0.0f) denom = 1.0f;
        float cs = lo - f_lo * (hi - lo) / denom;
        float edge = fabsf(f_lo) <= fabsf(f_hi) ? lo : hi;
        bool good = cs > lo && cs < hi && isfinite(cs);
        float width = hi - lo;
        float sl = (f_hi - f_lo) / (width == 0.0f ? 1.0f : width);
        c_out[lane] = good ? cs : edge;
        found_out[lane] = found;
        slope_out[lane] = found ? sl : 0.0f;
    }
}

template <int IWAVE>
int launch(const float *props, const float *rho, const float *omegas,
           const float *c_prev,
           const float *cm, const float *bx, const float *top,
           const float *slope_prev, int nl, int C, int R, int max_steps,
           int nbisect, int newton_iters, float maxshift, int has_slope,
           int threads, int tile, int smem, float *c_out, bool *found_out,
           float *slope_out, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            walk_kernel<IWAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    int blocks = (C + tile - 1) / tile;
    walk_kernel<IWAVE><<<blocks, threads, smem, stream>>>(
        props, rho, omegas, c_prev, cm, bx, top, slope_prev, nl, C, R,
        max_steps,
        nbisect, newton_iters, maxshift, has_slope, tile, c_out, found_out,
        slope_out);
    return (int)cudaGetLastError();
}

}  // namespace

// threads, tile and smem come from ops/walk.py geometry
extern "C" int bh_walk(const float *props, const float *rho,
                       const float *omegas,
                       const float *c_prev, const float *cm, const float *bx,
                       const float *top, const float *slope_prev, int nl,
                       int C, int R, int max_steps, int nbisect,
                       int newton_iters, float maxshift, int has_slope,
                       int iwave, int threads, int tile, int smem,
                       float *c_out, bool *found_out, float *slope_out,
                       cudaStream_t stream) {
    if (iwave != 1 && iwave != 2) return (int)cudaErrorInvalidValue;
    // the kernel's shared-memory layout: planes, cm, bx, the threads'
    // invariant columns, then top and order
    const long ninv = iwave == 2 ? 3 : 2;
    const long need = 4 * (4L * nl * tile + 2L * tile
                           + ninv * (nl - 1) * threads + 2L * tile);
    if (threads < 32 || threads > WALK_MAX_THREADS || threads % 32 != 0
        || tile < 1 || nl < 2 || smem < need)
        return (int)cudaErrorInvalidConfiguration;
    if ((long)C * R == 0) return 0;
    if (iwave == 1)
        return launch<1>(props, rho, omegas, c_prev, cm, bx, top, slope_prev,
                         nl, C, R, max_steps, nbisect, newton_iters, maxshift,
                         has_slope, threads, tile, smem, c_out, found_out,
                         slope_out, stream);
    return launch<2>(props, rho, omegas, c_prev, cm, bx, top, slope_prev, nl,
                     C, R, max_steps, nbisect, newton_iters, maxshift,
                     has_slope, threads, tile, smem, c_out, found_out,
                     slope_out, stream);
}
