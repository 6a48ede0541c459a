// The real functions of the kernels that have a float32 and a float64
// instance (K3, K4, K5, K6), overloaded on the scalar type so that a
// template on it calls sqrtf, sinf, ... in the float instance, as the
// float-only sources did, and sqrt, sin, ... in the double one.  All
// are the IEEE or full-precision library forms (no intrinsics), the
// forms PyTorch's CUDA operators call, so each instance rounds as the
// plain twins run on the card at its type.
#pragma once

static __device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
static __device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
static __device__ __forceinline__ float msin(float x) { return sinf(x); }
static __device__ __forceinline__ double msin(double x) { return sin(x); }
static __device__ __forceinline__ float mcos(float x) { return cosf(x); }
static __device__ __forceinline__ double mcos(double x) { return cos(x); }
static __device__ __forceinline__ float mexp(float x) { return expf(x); }
static __device__ __forceinline__ double mexp(double x) { return exp(x); }
static __device__ __forceinline__ float mlog(float x) { return logf(x); }
static __device__ __forceinline__ double mlog(double x) { return log(x); }
static __device__ __forceinline__ float mabs(float x) { return fabsf(x); }
static __device__ __forceinline__ double mabs(double x) { return fabs(x); }
static __device__ __forceinline__ float mmax(float a, float b) {
    return fmaxf(a, b);
}
static __device__ __forceinline__ double mmax(double a, double b) {
    return fmax(a, b);
}
