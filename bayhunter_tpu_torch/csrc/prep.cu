// K1: the model kernel, and K6: its RF part alone; one thread per chain.
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
// same RF rows (flatten and rf_rows below, shared with K1) from (NL, C)
// layer planes, for the cold evaluation and the batched RF forward.
// Plain twin: ops/prep.py rf_operands_plain.
//
// From the depth-sorted (NL, C) nucleus planes it computes the layered
// model, the prior validity, the walker planes [d; a; b; rho], cm (0.95
// 0.90 gtsolh), betmx and the deepest layer, then the rfmini flattening
// (R = 6371 km) and, for each RF target, the (NL-1) x 32
// welded-interface R/T table and the per-chain RF pack (rows named by
// pack.cuh's PackLayout; its t0 uses vp for P and vs for SV
// incidence).  All outputs are (rows, C): neighbouring threads store
// neighbouring addresses.
//
// Bound on the card: stores — 84 + 4 floats and 640 + 88 per RF target
// written per chain against 42 read (K6: 640 + 88 written against 84
// read), with a few thousand flops per chain.  The per-chain layer
// arrays live in local memory (L1-resident).  Left for later work:
// fusing the operand packs into their consumers so that the 640-row
// coefficient table never reaches device memory.
#include <cuda_runtime.h>

#include "cplx.cuh"
#include "pack.cuh"

#define NL_MAX 64
#define RF_MAX 4

// K1's RF targets: slowness (s/km), wave type and the output planes of
// each; ops/_ext.py RfSpecs mirrors it
struct RfSpecs {
    int n;
    float p[RF_MAX];
    int wave[RF_MAX];
    float *coefs[RF_MAX];
    float *pack[RF_MAX];
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

// rfmini flattening (R = 6371 km) of one chain's layer arrays, in place
// (pallas_prep._rf_rows).  Shared by K1 and K6.
__device__ __forceinline__ void flatten(int nl, float *h, float *vp,
                                        float *vsl, float *rho) {
    const float R = 6371.0f;
    float zt = 0.0f;
    for (int i = 0; i < nl; ++i) {
        float z_bot = zt + h[i];
        float q_top = R / (R - zt);
        float zf_top = R * logf(q_top);
        float zf_bot = R * logf(R / (R - z_bot));
        zt = zt + h[i];
        h[i] = zf_bot - zf_top;
        vp[i] = vp[i] * q_top;
        vsl[i] = vsl[i] * q_top;
        rho[i] = rho[i] / q_top;
    }
}

// RF operands of one chain from its flattened layer arrays
// (pallas_prep._rf_rows) at slowness p for incidence wave (0 = P,
// 1 = SV): the (NL-1) x 32 welded-interface R/T table and the
// per-chain pack (rows named by pack.cuh's PackLayout).  Shared by K1
// and K6.
__device__ __forceinline__ void rf_rows(int nl, int C, int c, float p,
                                        int wave, const PackLayout &lay,
                                        const float *h, const float *vp,
                                        const float *vsl, const float *rho,
                                        float *__restrict__ coefs,
                                        float *__restrict__ pack) {
    m4 mats[4];
    int depth = 0;
    for (int l = 0; l < nl - 1; ++l) {
        interface_coeffs(p, vp[l], vsl[l], rho[l], vp[l + 1], vsl[l + 1],
                         rho[l + 1], mats);
        float *out = coefs + (size_t)l * 32 * C + c;
        for (int m = 0; m < 4; ++m) {
            const cf *e = &mats[m].a11;
            for (int k = 0; k < 4; ++k) {
                out[(size_t)(m * 8 + 2 * k) * C] = e[k].re;
                out[(size_t)(m * 8 + 2 * k + 1) * C] = e[k].im;
            }
        }
        bool real = h[l] > 0.0f || vp[l] != vp[l + 1] || vsl[l] != vsl[l + 1]
                    || rho[l] != rho[l + 1];
        if (real) depth = l;
    }
    // direct-arrival time of the incident wave
    const float *v = wave == 0 ? vp : vsl;
    float t0 = 0.0f;
    for (int i = 0; i < nl; ++i) {
        float qv = sqrtf(fmaxf(1.0f / (v[i] * v[i]) - p * p, 0.0f));
        t0 = t0 + (i < nl - 1 ? h[i] : -1.0f) * qv;
    }
    m4 hm = displacement(p, vp[0], vsl[0]);
    m4 nt = free_surface(p, vp[0], vsl[0]);

    float *pk = pack + c;
    auto put = [&](int row, float val) { pk[(size_t)row * C] = val; };
    for (int i = 0; i < nl; ++i) {
        put(lay.h + i, h[i]);
        put(lay.vp + i, vp[i]);
        put(lay.vs + i, vsl[i]);
    }
    put(lay.p, p);
    put(lay.t0, t0);
    const cf *hmv = &hm.a11;
    const cf *ntv = &nt.a11;
    for (int k = 0; k < 4; ++k) {
        put(lay.hmat + 2 * k, hmv[k].re);
        put(lay.hmat + 2 * k + 1, hmv[k].im);
        put(lay.nt + 2 * k, ntv[k].re);
        put(lay.nt + 2 * k + 1, ntv[k].im);
    }
    put(lay.depth, (float)depth);
    for (int row = lay.depth + 1; row < lay.rows; ++row) put(row, 0.0f);
}

struct PriorCfg {
    int layermin, layermax;
    float vsmin, vsmax, zmin, zmax, thickmin, lvz_factor, hvz_factor;
    int use_lvz, use_hvz;
};

__global__ void prep_kernel(const float *__restrict__ vs_t,
                            const float *__restrict__ z_t,
                            const int *__restrict__ n_in,
                            const float *__restrict__ vpvs_in, int nl, int C,
                            PriorCfg cfg, RfSpecs rf, PackLayout lay,
                            bool *__restrict__ valid_out,
                            float *__restrict__ props,
                            float *__restrict__ cm_out,
                            float *__restrict__ bx_out,
                            float *__restrict__ top_out) {
    int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    float vs[NL_MAX], z[NL_MAX], h[NL_MAX], vp[NL_MAX], vsl[NL_MAX],
        rho[NL_MAX];
    for (int i = 0; i < nl; ++i) {
        vs[i] = vs_t[(size_t)i * C + c];
        z[i] = z_t[(size_t)i * C + c];
    }
    int n = n_in[c];
    float vpvs = vpvs_in[c];

    // voronoi -> layers (pallas_prep._voronoi_rows)
    int hs = min(max(n - 1, 0), nl - 1);
    float vs_hs = vs[hs];
    float vp_hs = vs_hs * vpvs;
    float zd_prev = 0.0f;
    for (int i = 0; i < nl; ++i) {
        float z_next = i < nl - 1 ? z[i + 1] : z[nl - 1];
        float zd = 0.5f * (z[i] + z_next);
        bool finite = i < n - 1;
        h[i] = finite ? zd - zd_prev : 0.0f;
        zd_prev = zd;
        vsl[i] = finite ? vs[i] : vs_hs;
        vp[i] = finite ? vs[i] * vpvs : vp_hs;
        rho[i] = vp[i] * 0.32f + 0.77f;
    }

    // prior validity (pallas_prep._valid_rows)
    int nlayer = n - 1;
    bool ok = nlayer >= cfg.layermin && nlayer <= cfg.layermax;
    float acc = 0.0f;
    for (int i = 0; i < nl; ++i) {
        bool valid = i < n;
        bool pair = i < n - 1;
        if (pair && !(h[i] >= cfg.thickmin)) ok = false;
        if (valid && !(vs[i] >= cfg.vsmin && vs[i] <= cfg.vsmax)) ok = false;
        acc = acc + h[i];
        if (valid && !(acc >= cfg.zmin && acc <= cfg.zmax)) ok = false;
        float vs_next = i < nl - 1 ? vs[i + 1] : vs[i];
        if (pair && cfg.use_lvz && !(vs_next - vs[i] * cfg.lvz_factor > 0.0f))
            ok = false;
        if (pair && cfg.use_hvz && !(vs[i] * cfg.hvz_factor - vs_next > 0.0f))
            ok = false;
    }
    valid_out[c] = ok;

    // SWD operands, flat earth (pallas_prep._swd_rows)
    int jmn = 0;
    float betmn = 0.0f, bx = 0.0f;
    int top = -1;
    for (int i = 0; i < nl; ++i) {
        float cand = vsl[i] > 0.01f ? vsl[i] : vp[i];
        if (i == 0 || cand < betmn) {
            betmn = cand;
            jmn = i;
        }
        bx = i == 0 ? vsl[i] : fmaxf(bx, vsl[i]);
        if (h[i] > 0.0f) top = i;
        props[(size_t)i * C + c] = h[i];
        props[(size_t)(nl + i) * C + c] = vp[i];
        props[(size_t)(2 * nl + i) * C + c] = vsl[i];
        props[(size_t)(3 * nl + i) * C + c] = rho[i];
    }
    float cc1 = vsl[jmn] > 0.01f ? gtsolh(vp[jmn], vsl[jmn]) : betmn;
    cm_out[c] = (float)(0.95 * 0.90) * cc1;
    bx_out[c] = bx;
    top_out[c] = (float)top;

    flatten(nl, h, vp, vsl, rho);
    for (int s = 0; s < rf.n; ++s)
        rf_rows(nl, C, c, rf.p[s], rf.wave[s], lay, h, vp, vsl, rho,
                rf.coefs[s], rf.pack[s]);
}

// K6: the RF operands alone, from (NL, C) layer planes.
__global__ void rf_prep_kernel(const float *__restrict__ h_in,
                               const float *__restrict__ vp_in,
                               const float *__restrict__ vs_in,
                               const float *__restrict__ rho_in, int nl,
                               int C, float p, int wave, PackLayout lay,
                               float *__restrict__ coefs,
                               float *__restrict__ pack) {
    int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    float h[NL_MAX], vp[NL_MAX], vsl[NL_MAX], rho[NL_MAX];
    for (int i = 0; i < nl; ++i) {
        size_t k = (size_t)i * C + c;
        h[i] = h_in[k];
        vp[i] = vp_in[k];
        vsl[i] = vs_in[k];
        rho[i] = rho_in[k];
    }
    flatten(nl, h, vp, vsl, rho);
    rf_rows(nl, C, c, p, wave, lay, h, vp, vsl, rho, coefs, pack);
}

}  // namespace

extern "C" int bh_prep(const float *vs_t, const float *z_t, const int *n,
                       const float *vpvs, int nl, int C, int layermin,
                       int layermax, float vsmin, float vsmax, float zmin,
                       float zmax, float thickmin, float lvz_factor,
                       float hvz_factor, int use_lvz, int use_hvz, RfSpecs rf,
                       PackLayout lay, bool *valid, float *props, float *cm,
                       float *bx, float *top, cudaStream_t stream) {
    if (nl > NL_MAX || nl < 2 || rf.n < 0 || rf.n > RF_MAX)
        return (int)cudaErrorInvalidValue;
    for (int s = 0; s < rf.n; ++s)
        if (rf.wave[s] != 0 && rf.wave[s] != 1)
            return (int)cudaErrorInvalidValue;
    if (C == 0) return 0;
    PriorCfg cfg = {layermin, layermax, vsmin, vsmax, zmin, zmax,
                    thickmin, lvz_factor, hvz_factor, use_lvz, use_hvz};
    int threads = 128;
    int blocks = (C + threads - 1) / threads;
    prep_kernel<<<blocks, threads, 0, stream>>>(
        vs_t, z_t, n, vpvs, nl, C, cfg, rf, lay, valid, props, cm, bx, top);
    return (int)cudaGetLastError();
}

extern "C" int bh_rf_prep(const float *h, const float *vp, const float *vs,
                          const float *rho, int nl, int C, float p, int wave,
                          PackLayout lay, float *coefs, float *pack,
                          cudaStream_t stream) {
    if (nl > NL_MAX || nl < 2 || (wave != 0 && wave != 1))
        return (int)cudaErrorInvalidValue;
    if (C == 0) return 0;
    int threads = 128;
    int blocks = (C + threads - 1) / threads;
    rf_prep_kernel<<<blocks, threads, 0, stream>>>(h, vp, vs, rho, nl, C, p,
                                                   wave, lay, coefs, pack);
    return (int)cudaGetLastError();
}

extern "C" const char *bh_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
