// K1: the model kernel, and K6: its RF part alone; a block per tile of
// whole chains.
//
// Replaces the TPU kernel bayhunter_tpu/ops/pallas_prep.py:315
// (_model_kernel with _voronoi_rows :173, its mantle arm :176-200
// included, _valid_rows :210, _swd_rows :255 and _rf_rows :63, driven
// by model_operands_t :340) for one flat-earth Rayleigh target and one
// receiver-function operand set per RF target (RfSpecs below: slowness
// and wave type each, as the TPU kernel's ``specs`` tuple gives them).
// Plain twin: bayhunter_tpu_torch/ops/prep.py model_operands_plain.
//
// K6 replaces the TPU kernel bayhunter_tpu/ops/pallas_prep.py:141
// (_prep_kernel, body _rf_rows :63, driven by rf_operands_t :436): the
// same RF rows (flatten_slot and rf_item below, shared with K1) from
// (NL, C) layer planes, for the cold evaluation and the batched RF
// forward, with the flattening (rf_prep_kernel<true>) or on the raw
// layers (rf_prep_kernel<false>, _rf_rows with flattening=False :70).
// Plain twin: ops/prep.py rf_operands_plain.
//
// From the depth-sorted (NL, C) nucleus planes K1 computes the layered
// model, the prior validity, the walker planes [d; a; b; rho], cm (0.95
// 0.90 gtsolh), betmx and the deepest layer, then the rfmini flattening
// (R = 6371 km) and, for each RF target, the (NL-1) x 32
// welded-interface R/T table and the per-chain RF pack (rows named by
// pack.cuh's PackLayout; its t0 uses vp for P and vs for SV
// incidence).  All outputs are (rows, C) planes of one output buffer
// (rows: props 0..4 NL-1, cm 4 NL, bx 4 NL + 1, top 4 NL + 2, then
// each RF target's table and pack at the rows RfSpecs names; K6: its
// table, then its pack), so neighbouring threads store neighbouring
// addresses.
//
// Bound on the card: stores — 84 + 4 floats and 640 + 88 per RF target
// written per chain against 42 read (K6: 640 + 88 written against 84
// read), with some 10,000 float32 operations per chain and RF target,
// most of them in the 20 interface_coeffs calls.  One thread per chain
// left the card idle: 10,240 chains were 80 blocks of 128 threads on 132
// SMs (a 2,048-chain cold chunk 16), each thread ran its 20 interfaces
// one after another, and its six layer arrays lived in local memory.
// What bounds the tiles instead (NVIDIA H100 80GB HBM3, 700 W, 10,240
// chains, NL 21): the model part alone takes 0.0070 ms, the latency of
// the per-chain scans between four barriers while the card's memory
// idles, and the RF part then runs the interface arithmetic (latency
// at 16-24 resident warps per SM) and the coefficient stores side by
// side, each of them nearly as long as the two together — 0.0265 ms in
// all against a 0.0105 ms byte bound.  The design:
//   * a block takes a tile of whole chains (ops/prep.py geometry: 32,
//     or 16 where 32 would give fewer than two blocks per SM) and
//     stages the tile's raw planes and its layered, then flattened
//     h, vp, vs, rho in shared memory, laid out [plane][layer][chain]
//     so that a warp's lanes read neighbouring banks;
//   * what is sequential runs one thread per chain and keeps the twin's
//     order: the validity scan with the running depth (which is the
//     flattening's running zt), and the SWD scan with gtsolh, the two
//     as separate items so that two warps run them side by side; the
//     direct-arrival time's running sum and the skip depth per chain
//     and RF target;
//   * everything else runs per (layer, chain) or per (interface,
//     chain) item over all of the block's threads: the Voronoi layers
//     and the walker-plane stores, the flattening of each slot from its
//     running depths, interface_coeffs and its 32 stores, the pack's
//     plane and padding rows — at 10,240 chains and NL 21, 204,800
//     interface items per RF target where there were 10,240 threads.
//   * the mantle prior (prep_kernel<true>, chosen by PriorCfg's
//     use_mantle): vp = vs * mantle vp/vs from the chain's first slot
//     below n whose vs reaches the threshold downward, the halfspace
//     value included.  That first slot is a per-chain minimum over the
//     chain's slots, which lie tc threads apart: each (slot, chain)
//     item that qualifies takes a shared-memory atomicMin on its
//     chain's entry (one extra pass and barrier), so no item scans its
//     chain's nl slots.  The entry lives in the first row of the
//     running depths, which the validity scan writes only after the
//     Voronoi pass; prep_kernel<false> keeps the no-mantle instruction
//     stream as it was.
//   * the spherical earth (prep_sph_kernel<MANTLE>, launched when
//     SwdSets asks for a spherical set; pallas_prep._swd_rows
//     iflsph == 1, :264-285): after the validity scan, one item per
//     (slot, chain) flattens the slot from the chain's running depths
//     (the halfspace slot takes a fictitious 1 km for its bottom):
//     d = R ln(R/r1) - R ln(R/r0), a and b times 2R/(r0 + r1), rho
//     times exp(ex ln(2R/(r0 + r1))) with R = 6370 km; it writes the
//     spherical set [d; a; b; rho_R] (ex -2.275) and, when a spherical
//     Love target asks for it, the Love density plane (ex -5), and
//     stages d, a, b in three more shared planes; then one thread per
//     chain scans them for the set's cm, betmx and top beside the RF
//     flattening's slot items.  The flat set is written only when a
//     flat target asks for it.  prep_kernel<MANTLE> keeps the flat
//     instruction stream and output rows as they were.
// Left for later work: fusing the operand packs into their consumers
// so that the 640-row coefficient table never reaches device memory.
#include <cuda_runtime.h>

#include "cplx.cuh"
#include "pack.cuh"

#define RF_MAX 4

constexpr int PREP_MAX_THREADS = 256;  // ops/prep.py MAX_THREADS

// the prior bounds K1 checks, and the mantle prior (vs threshold,
// mantle vp/vs) when use_mantle is set; ops/_ext.py PriorCfg mirrors it
struct PriorCfg {
    int layermin, layermax;
    float vsmin, vsmax, zmin, zmax, thickmin, lvz_factor, hvz_factor;
    int use_lvz, use_hvz;
    float mantle_vs, mantle_vpvs;
    int use_mantle;
};

// K1's RF targets: slowness (s/km), wave type, and the output rows at
// which each target's table and pack start; ops/_ext.py RfSpecs
// mirrors it
struct RfSpecs {
    int n;
    float p[RF_MAX];
    int wave[RF_MAX];
    int coefs[RF_MAX];
    int pack[RF_MAX];
};

// K1's dispersion sets in the spherical kernels: the flat set [d; a;
// b; rho] + cm, bx, top at row 0 when ``flat``, the spherical set at
// ``sph_row`` when ``sph``, the spherical Love density plane at
// ``love_row`` when ``love``; ops/_ext.py SwdSets mirrors it
struct SwdSets {
    int flat, sph, love, sph_row, love_row;
};

namespace {

__device__ __forceinline__ float gtsolh(float a, float b) {
    float c = 0.95f * b;
    for (int i = 0; i < 5; ++i) {
        float gamma = b / a;
        float kappa = c / b;
        float k2 = kappa * kappa;
        float gk = gamma * kappa;
        float gk2 = gk * gk;
        float fac1 = sqrtf(fmaxf(1.0f - gk2, 1e-30f));
        float fac2 = sqrtf(fmaxf(1.0f - k2, 1e-30f));
        float tk = 2.0f - k2;
        float fr = tk * tk - 4.0f * fac1 * fac2;
        float frp = -4.0f * tk * kappa + 4.0f * fac2 * gamma * gamma * kappa / fac1
                    + 4.0f * fac1 * kappa / fac2;
        frp = frp / b;
        c = c - fr / frp;
    }
    return c;
}

// The SWD scalars of chain c from its layer planes d, a, b (slot i at
// i * tile + c): cm = 0.95 0.90 gtsolh at the slowest layer (its
// velocity if fluid), betmx and the deepest slot with d > 0
// (pallas_prep._swd_rows), stored at rows 0, 1, 2 of ``out`` (row
// stride C).
__device__ __forceinline__ void swd_scalars(int nl, int c, int tile, int C,
                                            const float *d, const float *a,
                                            const float *b, float *out) {
    int jmn = 0;
    float betmn = 0.0f, bx = 0.0f;
    int top = -1;
    for (int i = 0; i < nl; ++i) {
        int s = i * tile + c;
        float bi = b[s];
        float cand = bi > 0.01f ? bi : a[s];
        if (i == 0 || cand < betmn) {
            betmn = cand;
            jmn = i;
        }
        bx = i == 0 ? bi : fmaxf(bx, bi);
        if (d[s] > 0.0f) top = i;
    }
    int s = jmn * tile + c;
    float cc1 = b[s] > 0.01f ? gtsolh(a[s], b[s]) : betmn;
    out[c] = (float)(0.95 * 0.90) * cc1;
    out[(size_t)C + c] = bx;
    out[(size_t)2 * C + c] = (float)top;
}

// Spherical-earth flattening of one slot for the dispersion solver
// (pallas_prep._swd_rows iflsph == 1; surfdisp96.f:486-553, R = 6370
// km): zt and zb the slot's running depths at its top and bottom.
// rho_r takes the Rayleigh exponent -2.275, rho_l the Love -5, each as
// exp(ex ln(tmp)), the TPU kernel's form.
__device__ __forceinline__ void sphere_slot(float zt, float zb, float vp,
                                            float vs, float rho, float &d,
                                            float &a, float &b, float &rho_r,
                                            float &rho_l) {
    const float R = 6370.0f;
    float r0 = R - zt;
    float r1 = R - zb;
    float z0 = R * logf(R / r0);
    float z1 = R * logf(R / r1);
    d = z1 - z0;
    float tmp = (R + R) / (r0 + r1);
    a = vp * tmp;
    b = vs * tmp;
    float lt = logf(tmp);
    rho_r = rho * expf(-2.275f * lt);
    rho_l = rho * expf(-5.0f * lt);
}

// A tile's layer planes in shared memory, [plane][layer][chain]: slot
// i of chain c of a plane at i * tile + c.  K1 is float; K6 and the RF
// functions below are templates on the scalar type T (float, and double
// for K6), their literals T(...).
template <class T>
struct Planes_t {
    T *h, *vp, *vs, *rho;
    int tile;
};
using Planes = Planes_t<float>;

// rfmini flattening (R = 6371 km) of one slot in place
// (pallas_prep._rf_rows): zt and z_bot are the chain's running depths
// at the slot's top and bottom.  Shared by K1 and K6.
template <class T>
__device__ __forceinline__ void flatten_slot(T zt, T z_bot, T &h, T &vp,
                                             T &vs, T &rho) {
    const T R = T(6371);
    T q_top = R / (R - zt);
    T zf_top = R * mlog(q_top);
    T zf_bot = R * mlog(R / (R - z_bot));
    h = zf_bot - zf_top;
    vp = vp * q_top;
    vs = vs * q_top;
    rho = rho / q_top;
}

// The running depths zt[0..nl] of chain c (zt[i + 1] = zt[i] + h[i],
// from 0).
template <class T>
__device__ __forceinline__ void running_depths(int nl, int c,
                                               const Planes_t<T> &f, T *zt) {
    T acc = T(0);
    zt[c] = T(0);
    for (int i = 0; i < nl; ++i) {
        acc = acc + f.h[i * f.tile + c];
        zt[(i + 1) * f.tile + c] = acc;
    }
}

// Flattens the tile's nl x tc slots in place, one item per slot.
template <class T>
__device__ __forceinline__ void flatten_tile(int nl, int tc,
                                             const Planes_t<T> &f,
                                             const T *zt) {
    for (int k = threadIdx.x; k < nl * tc; k += blockDim.x) {
        int i = k / tc, c = k - i * tc;
        int s = i * f.tile + c;
        flatten_slot(zt[s], zt[s + f.tile], f.h[s], f.vp[s], f.vs[s],
                     f.rho[s]);
    }
}

// The items of one RF target for a tile of tc chains: (NL-1) x tc
// interface items, then tc chain items, then plane_rows x tc pack-row
// items (ops/prep.py item_stores mirrors the map).
__device__ __forceinline__ int plane_rows(int nl, const PackLayout &lay) {
    return 3 * nl + 1 + (lay.rows - lay.depth - 1);
}

__device__ __forceinline__ int rf_items(int nl, int tc,
                                        const PackLayout &lay) {
    return (nl - 1) * tc + tc + plane_rows(nl, lay) * tc;
}

// Item k of one RF target (slowness p, incidence wave: 0 = P, 1 = SV)
// from the tile's flattened planes (pallas_prep._rf_rows): an
// interface's 32 rows of the R/T table, a chain's direct-arrival time,
// displacement and free-surface matrices and skip depth, or one pack
// row (flattened h, vp, vs, the slowness, or padding).  ``coefs`` and
// ``pack`` point at the tile's first chain.  Shared by K1 and K6.
template <class T>
__device__ __forceinline__ void rf_item(int k, int nl, int C, int tc, T p,
                                        int wave, const PackLayout &lay,
                                        const Planes_t<T> &f,
                                        T *__restrict__ coefs,
                                        T *__restrict__ pack) {
    const int TL = f.tile;
    const int n_if = (nl - 1) * tc;
    if (k < n_if) {
        int l = k / tc, c = k - l * tc;
        int s = l * TL + c;
        mat4<T> mats[4];
        interface_coeffs(p, f.vp[s], f.vs[s], f.rho[s], f.vp[s + TL],
                         f.vs[s + TL], f.rho[s + TL], mats);
        T *out = coefs + (size_t)l * 32 * C + c;
        for (int m = 0; m < 4; ++m) {
            const cplx<T> *e = &mats[m].a11;
            for (int j = 0; j < 4; ++j) {
                out[(size_t)(m * 8 + 2 * j) * C] = e[j].re;
                out[(size_t)(m * 8 + 2 * j + 1) * C] = e[j].im;
            }
        }
        return;
    }
    k -= n_if;
    if (k < tc) {
        const int c = k;
        // direct-arrival time of the incident wave
        const T *v = wave == 0 ? f.vp : f.vs;
        T t0 = T(0);
        for (int i = 0; i < nl; ++i) {
            T vi = v[i * TL + c];
            T qv = msqrt(mmax(T(1) / (vi * vi) - p * p, T(0)));
            t0 = t0 + (i < nl - 1 ? f.h[i * TL + c] : T(-1)) * qv;
        }
        int depth = 0;
        for (int l = 0; l < nl - 1; ++l) {
            int s = l * TL + c;
            bool real = f.h[s] > T(0) || f.vp[s] != f.vp[s + TL]
                        || f.vs[s] != f.vs[s + TL]
                        || f.rho[s] != f.rho[s + TL];
            if (real) depth = l;
        }
        mat4<T> hm = displacement(p, f.vp[c], f.vs[c]);
        mat4<T> nt = free_surface(p, f.vp[c], f.vs[c]);
        T *pk = pack + c;
        pk[(size_t)lay.t0 * C] = t0;
        const cplx<T> *hmv = &hm.a11;
        const cplx<T> *ntv = &nt.a11;
        for (int j = 0; j < 4; ++j) {
            pk[(size_t)(lay.hmat + 2 * j) * C] = hmv[j].re;
            pk[(size_t)(lay.hmat + 2 * j + 1) * C] = hmv[j].im;
            pk[(size_t)(lay.nt + 2 * j) * C] = ntv[j].re;
            pk[(size_t)(lay.nt + 2 * j + 1) * C] = ntv[j].im;
        }
        pk[(size_t)lay.depth * C] = (T)depth;
        return;
    }
    k -= tc;
    int q = k / tc, c = k - q * tc;
    int row;
    T val;
    if (q < 3 * nl) {
        int plane = q / nl, i = q - plane * nl;
        const T *src = plane == 0 ? f.h : plane == 1 ? f.vp : f.vs;
        row = (plane == 0 ? lay.h : plane == 1 ? lay.vp : lay.vs) + i;
        val = src[i * TL + c];
    } else if (q == 3 * nl) {
        row = lay.p;
        val = p;
    } else {
        row = lay.depth + (q - 3 * nl);   // padding after the depth row
        val = T(0);
    }
    pack[(size_t)row * C + c] = val;
}

// a[s] with constant indices only (a kernel parameter's array indexed
// at run time would be copied to local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[RF_MAX], int s) {
    V v = a[0];
#pragma unroll
    for (int j = 1; j < RF_MAX; ++j)
        if (s == j) v = a[j];
    return v;
}

// The prior validity of chain c (pallas_prep._valid_rows) from its raw
// nuclei and layers, and its running depths (the flattening's zt).
__device__ __forceinline__ bool validity(int nl, int c, int n,
                                         const PriorCfg &cfg,
                                         const float *vs, const Planes &f,
                                         float *zt) {
    const int T = f.tile;
    int nlayer = n - 1;
    bool ok = nlayer >= cfg.layermin && nlayer <= cfg.layermax;
    float acc = 0.0f;
    zt[c] = 0.0f;
    for (int i = 0; i < nl; ++i) {
        bool valid = i < n;
        bool pair = i < n - 1;
        float hi = f.h[i * T + c];
        float vsi = vs[i * T + c];
        if (pair && !(hi >= cfg.thickmin)) ok = false;
        if (valid && !(vsi >= cfg.vsmin && vsi <= cfg.vsmax)) ok = false;
        acc = acc + hi;
        zt[(i + 1) * T + c] = acc;
        if (valid && !(acc >= cfg.zmin && acc <= cfg.zmax)) ok = false;
        float vs_next = i < nl - 1 ? vs[(i + 1) * T + c] : vsi;
        if (pair && cfg.use_lvz && !(vs_next - vsi * cfg.lvz_factor > 0.0f))
            ok = false;
        if (pair && cfg.use_hvz && !(vsi * cfg.hvz_factor - vs_next > 0.0f))
            ok = false;
    }
    return ok;
}

// K1: the tile's nuclei -> validity, walker operands and one RF operand
// set per RF target; MANTLE: with the mantle prior; SPH: with the
// spherical set (SwdSets).
template <bool MANTLE, bool SPH>
__device__ __forceinline__ void model_body(
    const float *__restrict__ vs_t, const float *__restrict__ z_t,
    const int *__restrict__ n_in, const float *__restrict__ vpvs_in, int nl,
    int C, const PriorCfg &cfg, const RfSpecs &rf, const SwdSets &sw,
    const PackLayout &lay, int tile, bool *__restrict__ valid_out,
    float *__restrict__ out) {
    extern __shared__ float4 smem4[];
    float *sm = reinterpret_cast<float *>(smem4);
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int c_base = blockIdx.x * tile;
    const int tc = min(tile, C - c_base);
    const int P = nl * tile;                          // one plane
    float *s_vs = sm;                                 // raw nuclei
    float *s_z = sm + P;
    Planes f = {sm + 2 * P, sm + 3 * P, sm + 4 * P, sm + 5 * P, tile};
    float *s_zt = sm + 6 * P;                         // (nl + 1) x tile
    float *s_vpvs = s_zt + P + tile;
    int *s_n = reinterpret_cast<int *>(s_vpvs + tile);
    float *props = out + c_base;
    // the spherical arm's flattened d, a, b (SPH only)
    float *s_sd = reinterpret_cast<float *>(s_n + tile);
    float *s_sa = s_sd + P;
    float *s_sb = s_sa + P;
    const bool flat = !SPH || sw.flat;

    for (int k = tid; k < nl * tc; k += T) {
        int i = k / tc, c = k - i * tc;
        size_t g = (size_t)i * C + c_base + c;
        s_vs[i * tile + c] = __ldg(vs_t + g);
        s_z[i * tile + c] = __ldg(z_t + g);
    }
    // the mantle arm's first slot per chain (nl: none), in the first
    // row of the running depths until the validity scan writes them
    int *s_first = reinterpret_cast<int *>(s_zt);
    for (int c = tid; c < tc; c += T) {
        s_n[c] = __ldg(n_in + c_base + c);
        s_vpvs[c] = __ldg(vpvs_in + c_base + c);
        if constexpr (MANTLE) s_first[c] = nl;
    }
    __syncthreads();
    if constexpr (MANTLE) {
        for (int k = tid; k < nl * tc; k += T) {
            int i = k / tc, c = k - i * tc;
            if (i < s_n[c] && s_vs[i * tile + c] >= cfg.mantle_vs)
                atomicMin(s_first + c, i);
        }
        __syncthreads();
    }

    // voronoi -> layers (pallas_prep._voronoi_rows), and the walker
    // planes (pallas_prep._swd_rows), one item per slot
    for (int k = tid; k < nl * tc; k += T) {
        int i = k / tc, c = k - i * tc;
        int n = s_n[c];
        float vpvs = s_vpvs[c];
        int hs = min(max(n - 1, 0), nl - 1);
        float vs_hs = s_vs[hs * tile + c];
        float vp_hs = vs_hs * vpvs;
        float z = s_z[i * tile + c];
        float z_next = i < nl - 1 ? s_z[(i + 1) * tile + c] : z;
        float zd = 0.5f * (z + z_next);
        float zd_prev = i > 0 ? 0.5f * (s_z[(i - 1) * tile + c] + z) : 0.0f;
        bool finite = i < n - 1;
        float vs = s_vs[i * tile + c];
        float h = finite ? zd - zd_prev : 0.0f;
        float vsl = finite ? vs : vs_hs;
        float vp;
        if constexpr (MANTLE) {
            // from the first mantle slot downward, the halfspace too
            int first = s_first[c];
            if (hs >= first) vp_hs = vs_hs * cfg.mantle_vpvs;
            vp = finite ? (i >= first ? vs * cfg.mantle_vpvs : vs * vpvs)
                        : vp_hs;
        } else {
            vp = finite ? vs * vpvs : vp_hs;
        }
        float rho = vp * 0.32f + 0.77f;
        int s = i * tile + c;
        f.h[s] = h;
        f.vp[s] = vp;
        f.vs[s] = vsl;
        f.rho[s] = rho;
        if (flat) {
            props[(size_t)i * C + c] = h;
            props[(size_t)(nl + i) * C + c] = vp;
            props[(size_t)(2 * nl + i) * C + c] = vsl;
            props[(size_t)(3 * nl + i) * C + c] = rho;
        }
    }
    __syncthreads();

    // the two per-chain scans, side by side: validity with the running
    // depths (pallas_prep._valid_rows), and the flat set's SWD scalars
    // (pallas_prep._swd_rows)
    for (int k = tid; k < (flat ? 2 : 1) * tc; k += T) {
        if (k < tc) {
            valid_out[c_base + k] = validity(nl, k, s_n[k], cfg, s_vs, f,
                                             s_zt);
            continue;
        }
        swd_scalars(nl, k - tc, tile, C, f.h, f.vp, f.vs,
                    props + (size_t)(4 * nl) * C);
    }
    __syncthreads();

    if constexpr (SPH) {
        // the spherical set, one item per slot, from the running depths
        // (the halfspace slot's bottom 1 km below its top)
        float *sph = out + (size_t)sw.sph_row * C + c_base;
        float *love = out + (size_t)sw.love_row * C + c_base;
        for (int k = tid; k < nl * tc; k += T) {
            int i = k / tc, c = k - i * tc;
            int s = i * tile + c;
            float zt = s_zt[s];
            float zb = i < nl - 1 ? s_zt[s + tile] : zt + 1.0f;
            float d, a, b, rho_r, rho_l;
            sphere_slot(zt, zb, f.vp[s], f.vs[s], f.rho[s], d, a, b, rho_r,
                        rho_l);
            if (i == nl - 1) d = 0.0f;
            s_sd[s] = d;
            s_sa[s] = a;
            s_sb[s] = b;
            sph[(size_t)i * C + c] = d;
            sph[(size_t)(nl + i) * C + c] = a;
            sph[(size_t)(2 * nl + i) * C + c] = b;
            sph[(size_t)(3 * nl + i) * C + c] = rho_r;
            if (sw.love) love[(size_t)i * C + c] = rho_l;
        }
        __syncthreads();
        // the spherical set's SWD scalars, one thread per chain, beside
        // the RF flattening's slot items
        for (int k = tid; k < tc + nl * tc; k += T) {
            if (k < tc) {
                swd_scalars(nl, k, tile, C, s_sd, s_sa, s_sb,
                            sph + (size_t)(4 * nl) * C);
                continue;
            }
            int i = (k - tc) / tc, c = k - tc - i * tc;
            int s = i * tile + c;
            flatten_slot(s_zt[s], s_zt[s + tile], f.h[s], f.vp[s], f.vs[s],
                         f.rho[s]);
        }
    } else {
        flatten_tile(nl, tc, f, s_zt);
    }
    __syncthreads();

    const int items = rf_items(nl, tc, lay);
    for (int k = tid; k < rf.n * items; k += T) {
        int s = k / items;
        rf_item(k - s * items, nl, C, tc, pick(rf.p, s), pick(rf.wave, s),
                lay, f, out + (size_t)pick(rf.coefs, s) * C + c_base,
                out + (size_t)pick(rf.pack, s) * C + c_base);
    }
}

// K1 with flat dispersion targets only (its output rows as ops/prep.py
// outputs() lays them out without SwdSets).
template <bool MANTLE>
__global__ void __launch_bounds__(PREP_MAX_THREADS)
prep_kernel(const float *__restrict__ vs_t, const float *__restrict__ z_t,
            const int *__restrict__ n_in, const float *__restrict__ vpvs_in,
            int nl, int C, PriorCfg cfg, RfSpecs rf, SwdSets sw,
            PackLayout lay, int tile, bool *__restrict__ valid_out,
            float *__restrict__ out) {
    model_body<MANTLE, false>(vs_t, z_t, n_in, vpvs_in, nl, C, cfg, rf, sw,
                              lay, tile, valid_out, out);
}

// K1 with a spherical set (and the flat set when a flat target asks).
template <bool MANTLE>
__global__ void __launch_bounds__(PREP_MAX_THREADS)
prep_sph_kernel(const float *__restrict__ vs_t,
                const float *__restrict__ z_t, const int *__restrict__ n_in,
                const float *__restrict__ vpvs_in, int nl, int C,
                PriorCfg cfg, RfSpecs rf, SwdSets sw, PackLayout lay,
                int tile, bool *__restrict__ valid_out,
                float *__restrict__ out) {
    model_body<MANTLE, true>(vs_t, z_t, n_in, vpvs_in, nl, C, cfg, rf, sw,
                             lay, tile, valid_out, out);
}

// K6: the RF operands alone, from (NL, C) layer planes; FLAT: with the
// rfmini flattening (pallas_prep._rf_rows ``flattening``), else the raw
// layers go straight into the tables, the scalars and the pack (the
// unflattened arm runs neither the running depths nor the logs).  T is
// the scalar type: float, or double for the float64 evaluation.
template <class T, bool FLAT>
__global__ void __launch_bounds__(PREP_MAX_THREADS)
rf_prep_kernel(const T *__restrict__ h_in, const T *__restrict__ vp_in,
               const T *__restrict__ vs_in, const T *__restrict__ rho_in,
               int nl, int C, T p, int wave, PackLayout lay, int tile,
               T *__restrict__ out) {
    extern __shared__ float4 smem4[];
    T *sm = reinterpret_cast<T *>(smem4);
    const int NT = blockDim.x;
    const int tid = threadIdx.x;
    const int c_base = blockIdx.x * tile;
    const int tc = min(tile, C - c_base);
    const int P = nl * tile;
    Planes_t<T> f = {sm, sm + P, sm + 2 * P, sm + 3 * P, tile};
    T *s_zt = sm + 4 * P;                             // (nl + 1) x tile

    for (int k = tid; k < nl * tc; k += NT) {
        int i = k / tc, c = k - i * tc;
        size_t g = (size_t)i * C + c_base + c;
        int s = i * tile + c;
        f.h[s] = __ldg(h_in + g);
        f.vp[s] = __ldg(vp_in + g);
        f.vs[s] = __ldg(vs_in + g);
        f.rho[s] = __ldg(rho_in + g);
    }
    __syncthreads();
    if constexpr (FLAT) {
        for (int c = tid; c < tc; c += NT) running_depths(nl, c, f, s_zt);
        __syncthreads();
        flatten_tile(nl, tc, f, s_zt);
        __syncthreads();
    }

    const int items = rf_items(nl, tc, lay);
    for (int k = tid; k < items; k += NT)
        rf_item(k, nl, C, tc, p, wave, lay, f, out + c_base,
                out + (size_t)(nl - 1) * 32 * C + c_base);
}

template <class T>
int launch_rf_prep(const T *h, const T *vp, const T *vs, const T *rho, int nl,
                   int C, T p, int wave, int flattening, PackLayout lay,
                   int threads, int tile, int smem, T *out,
                   cudaStream_t stream) {
    auto kernel = flattening ? rf_prep_kernel<T, true>
                             : rf_prep_kernel<T, false>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(C + tile - 1) / tile, threads, smem, stream>>>(
        h, vp, vs, rho, nl, C, p, wave, lay, tile, out);
    return (int)cudaGetLastError();
}

// Shared floats per chain of K1's and K6's tiles (ops/prep.py
// tile_floats); K1's spherical kernel adds its three staged planes.
constexpr int prep_floats(int nl) { return 7 * nl + 3; }
constexpr int prep_sph_floats(int nl) { return 10 * nl + 3; }
constexpr int rf_prep_floats(int nl) { return 5 * nl + 1; }

// bytes: the shared bytes per chain of the tile
int check_geometry(int nl, int threads, int tile, int smem, int bytes) {
    if (nl < 2) return (int)cudaErrorInvalidValue;
    if (threads < 32 || threads > PREP_MAX_THREADS || threads % 32 != 0
        || tile < 1 || smem < bytes * tile)
        return (int)cudaErrorInvalidConfiguration;
    return 0;
}

}  // namespace

// threads, tile and smem come from ops/prep.py geometry
extern "C" int bh_prep(const float *vs_t, const float *z_t, const int *n,
                       const float *vpvs, int nl, int C, PriorCfg cfg,
                       RfSpecs rf, SwdSets sw, PackLayout lay, int threads,
                       int tile, int smem, bool *valid, float *out,
                       cudaStream_t stream) {
    if (rf.n < 0 || rf.n > RF_MAX) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < rf.n; ++s)
        if (rf.wave[s] != 0 && rf.wave[s] != 1)
            return (int)cudaErrorInvalidValue;
    if (sw.love && !sw.sph) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, smem,
                               4 * (sw.sph ? prep_sph_floats(nl)
                                           : prep_floats(nl))))
        return e;
    if (C == 0) return 0;
    auto kernel = sw.sph
        ? (cfg.use_mantle ? prep_sph_kernel<true> : prep_sph_kernel<false>)
        : cfg.use_mantle ? prep_kernel<true> : prep_kernel<false>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(C + tile - 1) / tile, threads, smem, stream>>>(
        vs_t, z_t, n, vpvs, nl, C, cfg, rf, sw, lay, tile, valid, out);
    return (int)cudaGetLastError();
}

extern "C" int bh_rf_prep(const float *h, const float *vp, const float *vs,
                          const float *rho, int nl, int C, float p, int wave,
                          int flattening, PackLayout lay, int threads,
                          int tile, int smem, float *out,
                          cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, smem,
                               4 * rf_prep_floats(nl)))
        return e;
    if (C == 0) return 0;
    return launch_rf_prep<float>(h, vp, vs, rho, nl, C, p, wave, flattening,
                                 lay, threads, tile, smem, out, stream);
}

// K6 in double: the same kernel at the scalar type double
extern "C" int bh_rf_prep_f64(const double *h, const double *vp,
                              const double *vs, const double *rho, int nl,
                              int C, double p, int wave, int flattening,
                              PackLayout lay, int threads, int tile, int smem,
                              double *out, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, smem,
                               8 * rf_prep_floats(nl)))
        return e;
    if (C == 0) return 0;
    return launch_rf_prep<double>(h, vp, vs, rho, nl, C, p, wave, flattening,
                                  lay, threads, tile, smem, out, stream);
}

extern "C" const char *bh_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
