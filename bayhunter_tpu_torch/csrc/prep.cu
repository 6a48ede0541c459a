// K1: the model kernel, and K6: its RF part alone; a block per tile of
// whole chains.
//
// Replaces the TPU kernel bayhunter_tpu/ops/pallas_prep.py:315
// (_model_kernel with _voronoi_rows :173, _valid_rows :210,
// _swd_rows :255 and _rf_rows :63, driven by model_operands_t :340)
// for one flat-earth Rayleigh target and one receiver-function operand
// set per RF target (RfSpecs below: slowness and wave type each, as
// the TPU kernel's ``specs`` tuple gives them).
// Plain twin: bayhunter_tpu_torch/ops/prep.py model_operands_plain.
//
// K6 replaces the TPU kernel bayhunter_tpu/ops/pallas_prep.py:141
// (_prep_kernel, body _rf_rows :63, driven by rf_operands_t :436): the
// same RF rows (flatten_slot and rf_item below, shared with K1) from
// (NL, C) layer planes, for the cold evaluation and the batched RF
// forward.  Plain twin: ops/prep.py rf_operands_plain.
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
// Left for later work: fusing the operand packs into their consumers
// so that the 640-row coefficient table never reaches device memory.
#include <cuda_runtime.h>

#include "cplx.cuh"
#include "pack.cuh"

#define RF_MAX 4

constexpr int PREP_MAX_THREADS = 256;  // ops/prep.py MAX_THREADS

// the prior bounds K1 checks; ops/_ext.py PriorCfg mirrors it
struct PriorCfg {
    int layermin, layermax;
    float vsmin, vsmax, zmin, zmax, thickmin, lvz_factor, hvz_factor;
    int use_lvz, use_hvz;
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

// A tile's layer planes in shared memory, [plane][layer][chain]: slot
// i of chain c of a plane at i * tile + c.
struct Planes {
    float *h, *vp, *vs, *rho;
    int tile;
};

// rfmini flattening (R = 6371 km) of one slot in place
// (pallas_prep._rf_rows): zt and z_bot are the chain's running depths
// at the slot's top and bottom.  Shared by K1 and K6.
__device__ __forceinline__ void flatten_slot(float zt, float z_bot, float &h,
                                             float &vp, float &vs,
                                             float &rho) {
    const float R = 6371.0f;
    float q_top = R / (R - zt);
    float zf_top = R * logf(q_top);
    float zf_bot = R * logf(R / (R - z_bot));
    h = zf_bot - zf_top;
    vp = vp * q_top;
    vs = vs * q_top;
    rho = rho / q_top;
}

// The running depths zt[0..nl] of chain c (zt[i + 1] = zt[i] + h[i],
// from 0).
__device__ __forceinline__ void running_depths(int nl, int c, const Planes &f,
                                               float *zt) {
    float acc = 0.0f;
    zt[c] = 0.0f;
    for (int i = 0; i < nl; ++i) {
        acc = acc + f.h[i * f.tile + c];
        zt[(i + 1) * f.tile + c] = acc;
    }
}

// Flattens the tile's nl x tc slots in place, one item per slot.
__device__ __forceinline__ void flatten_tile(int nl, int tc, const Planes &f,
                                             const float *zt) {
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
__device__ __forceinline__ void rf_item(int k, int nl, int C, int tc,
                                        float p, int wave,
                                        const PackLayout &lay,
                                        const Planes &f,
                                        float *__restrict__ coefs,
                                        float *__restrict__ pack) {
    const int T = f.tile;
    const int n_if = (nl - 1) * tc;
    if (k < n_if) {
        int l = k / tc, c = k - l * tc;
        int s = l * T + c;
        m4 mats[4];
        interface_coeffs(p, f.vp[s], f.vs[s], f.rho[s], f.vp[s + T],
                         f.vs[s + T], f.rho[s + T], mats);
        float *out = coefs + (size_t)l * 32 * C + c;
        for (int m = 0; m < 4; ++m) {
            const cf *e = &mats[m].a11;
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
        const float *v = wave == 0 ? f.vp : f.vs;
        float t0 = 0.0f;
        for (int i = 0; i < nl; ++i) {
            float vi = v[i * T + c];
            float qv = sqrtf(fmaxf(1.0f / (vi * vi) - p * p, 0.0f));
            t0 = t0 + (i < nl - 1 ? f.h[i * T + c] : -1.0f) * qv;
        }
        int depth = 0;
        for (int l = 0; l < nl - 1; ++l) {
            int s = l * T + c;
            bool real = f.h[s] > 0.0f || f.vp[s] != f.vp[s + T]
                        || f.vs[s] != f.vs[s + T] || f.rho[s] != f.rho[s + T];
            if (real) depth = l;
        }
        m4 hm = displacement(p, f.vp[c], f.vs[c]);
        m4 nt = free_surface(p, f.vp[c], f.vs[c]);
        float *pk = pack + c;
        pk[(size_t)lay.t0 * C] = t0;
        const cf *hmv = &hm.a11;
        const cf *ntv = &nt.a11;
        for (int j = 0; j < 4; ++j) {
            pk[(size_t)(lay.hmat + 2 * j) * C] = hmv[j].re;
            pk[(size_t)(lay.hmat + 2 * j + 1) * C] = hmv[j].im;
            pk[(size_t)(lay.nt + 2 * j) * C] = ntv[j].re;
            pk[(size_t)(lay.nt + 2 * j + 1) * C] = ntv[j].im;
        }
        pk[(size_t)lay.depth * C] = (float)depth;
        return;
    }
    k -= tc;
    int q = k / tc, c = k - q * tc;
    int row;
    float val;
    if (q < 3 * nl) {
        int plane = q / nl, i = q - plane * nl;
        const float *src = plane == 0 ? f.h : plane == 1 ? f.vp : f.vs;
        row = (plane == 0 ? lay.h : plane == 1 ? lay.vp : lay.vs) + i;
        val = src[i * T + c];
    } else if (q == 3 * nl) {
        row = lay.p;
        val = p;
    } else {
        row = lay.depth + (q - 3 * nl);   // padding after the depth row
        val = 0.0f;
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
// set per RF target.
__global__ void __launch_bounds__(PREP_MAX_THREADS)
prep_kernel(const float *__restrict__ vs_t, const float *__restrict__ z_t,
            const int *__restrict__ n_in, const float *__restrict__ vpvs_in,
            int nl, int C, PriorCfg cfg, RfSpecs rf, PackLayout lay, int tile,
            bool *__restrict__ valid_out, float *__restrict__ out) {
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

    for (int k = tid; k < nl * tc; k += T) {
        int i = k / tc, c = k - i * tc;
        size_t g = (size_t)i * C + c_base + c;
        s_vs[i * tile + c] = __ldg(vs_t + g);
        s_z[i * tile + c] = __ldg(z_t + g);
    }
    for (int c = tid; c < tc; c += T) {
        s_n[c] = __ldg(n_in + c_base + c);
        s_vpvs[c] = __ldg(vpvs_in + c_base + c);
    }
    __syncthreads();

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
        float vp = finite ? vs * vpvs : vp_hs;
        float rho = vp * 0.32f + 0.77f;
        int s = i * tile + c;
        f.h[s] = h;
        f.vp[s] = vp;
        f.vs[s] = vsl;
        f.rho[s] = rho;
        props[(size_t)i * C + c] = h;
        props[(size_t)(nl + i) * C + c] = vp;
        props[(size_t)(2 * nl + i) * C + c] = vsl;
        props[(size_t)(3 * nl + i) * C + c] = rho;
    }
    __syncthreads();

    // the two per-chain scans, side by side: validity with the running
    // depths (pallas_prep._valid_rows), and the SWD scalars
    // (pallas_prep._swd_rows)
    for (int k = tid; k < 2 * tc; k += T) {
        if (k < tc) {
            valid_out[c_base + k] = validity(nl, k, s_n[k], cfg, s_vs, f,
                                             s_zt);
            continue;
        }
        const int c = k - tc;
        int jmn = 0;
        float betmn = 0.0f, bx = 0.0f;
        int top = -1;
        for (int i = 0; i < nl; ++i) {
            int s = i * tile + c;
            float vsl = f.vs[s];
            float cand = vsl > 0.01f ? vsl : f.vp[s];
            if (i == 0 || cand < betmn) {
                betmn = cand;
                jmn = i;
            }
            bx = i == 0 ? vsl : fmaxf(bx, vsl);
            if (f.h[s] > 0.0f) top = i;
        }
        int s = jmn * tile + c;
        float cc1 = f.vs[s] > 0.01f ? gtsolh(f.vp[s], f.vs[s]) : betmn;
        props[(size_t)(4 * nl) * C + c] = (float)(0.95 * 0.90) * cc1;
        props[(size_t)(4 * nl + 1) * C + c] = bx;
        props[(size_t)(4 * nl + 2) * C + c] = (float)top;
    }
    __syncthreads();

    flatten_tile(nl, tc, f, s_zt);
    __syncthreads();

    const int items = rf_items(nl, tc, lay);
    for (int k = tid; k < rf.n * items; k += T) {
        int s = k / items;
        rf_item(k - s * items, nl, C, tc, pick(rf.p, s), pick(rf.wave, s),
                lay, f, out + (size_t)pick(rf.coefs, s) * C + c_base,
                out + (size_t)pick(rf.pack, s) * C + c_base);
    }
}

// K6: the RF operands alone, from (NL, C) layer planes.
__global__ void __launch_bounds__(PREP_MAX_THREADS)
rf_prep_kernel(const float *__restrict__ h_in,
               const float *__restrict__ vp_in,
               const float *__restrict__ vs_in,
               const float *__restrict__ rho_in, int nl, int C, float p,
               int wave, PackLayout lay, int tile, float *__restrict__ out) {
    extern __shared__ float4 smem4[];
    float *sm = reinterpret_cast<float *>(smem4);
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int c_base = blockIdx.x * tile;
    const int tc = min(tile, C - c_base);
    const int P = nl * tile;
    Planes f = {sm, sm + P, sm + 2 * P, sm + 3 * P, tile};
    float *s_zt = sm + 4 * P;                         // (nl + 1) x tile

    for (int k = tid; k < nl * tc; k += T) {
        int i = k / tc, c = k - i * tc;
        size_t g = (size_t)i * C + c_base + c;
        int s = i * tile + c;
        f.h[s] = __ldg(h_in + g);
        f.vp[s] = __ldg(vp_in + g);
        f.vs[s] = __ldg(vs_in + g);
        f.rho[s] = __ldg(rho_in + g);
    }
    __syncthreads();
    for (int c = tid; c < tc; c += T) running_depths(nl, c, f, s_zt);
    __syncthreads();
    flatten_tile(nl, tc, f, s_zt);
    __syncthreads();

    const int items = rf_items(nl, tc, lay);
    for (int k = tid; k < items; k += T)
        rf_item(k, nl, C, tc, p, wave, lay, f, out + c_base,
                out + (size_t)(nl - 1) * 32 * C + c_base);
}

// Shared floats per chain of K1's and K6's tiles (ops/prep.py
// tile_floats).
constexpr int prep_floats(int nl) { return 7 * nl + 3; }
constexpr int rf_prep_floats(int nl) { return 5 * nl + 1; }

int check_geometry(int nl, int threads, int tile, int smem, int floats) {
    if (nl < 2) return (int)cudaErrorInvalidValue;
    if (threads < 32 || threads > PREP_MAX_THREADS || threads % 32 != 0
        || tile < 1 || smem < floats * tile * 4)
        return (int)cudaErrorInvalidConfiguration;
    return 0;
}

}  // namespace

// threads, tile and smem come from ops/prep.py geometry
extern "C" int bh_prep(const float *vs_t, const float *z_t, const int *n,
                       const float *vpvs, int nl, int C, PriorCfg cfg,
                       RfSpecs rf, PackLayout lay, int threads, int tile,
                       int smem, bool *valid, float *out,
                       cudaStream_t stream) {
    if (rf.n < 0 || rf.n > RF_MAX) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < rf.n; ++s)
        if (rf.wave[s] != 0 && rf.wave[s] != 1)
            return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, smem, prep_floats(nl)))
        return e;
    if (C == 0) return 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    prep_kernel<<<(C + tile - 1) / tile, threads, smem, stream>>>(
        vs_t, z_t, n, vpvs, nl, C, cfg, rf, lay, tile, valid, out);
    return (int)cudaGetLastError();
}

extern "C" int bh_rf_prep(const float *h, const float *vp, const float *vs,
                          const float *rho, int nl, int C, float p, int wave,
                          PackLayout lay, int threads, int tile, int smem,
                          float *out, cudaStream_t stream) {
    if (wave != 0 && wave != 1) return (int)cudaErrorInvalidValue;
    if (int e = check_geometry(nl, threads, tile, smem, rf_prep_floats(nl)))
        return e;
    if (C == 0) return 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rf_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    rf_prep_kernel<<<(C + tile - 1) / tile, threads, smem, stream>>>(
        h, vp, vs, rho, nl, C, p, wave, lay, tile, out);
    return (int)cudaGetLastError();
}

extern "C" const char *bh_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
