// f32 and the rng as the port's plain PyTorch versions compute them on the
// card, for the kernels held to them bit for bit (csrc/shade.cu K6/K7,
// csrc/refill.cu K13, csrc/bvh.cu K14/K15, csrc/interaction.cu K16): each
// product __fmul_rn, so that no multiply and add contract into an FMA that
// rounds once where two PyTorch ops round twice; clamp_min and clamp pass
// NaN on as PyTorch's do; the PCG chain of ops/rng.py in uint32, over the
// int64 words the pool keeps in [0, 2^32). Also the lane operands a kernel
// takes with their strides, and the steps more than one kernel shares: the
// Moller test of ops/shapes.py and the knot lookup of ops/spectrum.py.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kUnitF = (float)(0.9999 / 16777216.0);   // rng._UNIT_F
constexpr float kTriEps = 0.00001f;                      // shapes.TRI_EPS

// ---------------------------------------------------------------------------
// f32 as PyTorch's elementwise ops round it

__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sign(float x) {
    return (float)((0.f < x) - (x < 0.f));
}

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
// (N,) * (3, N): the lane's scalar times each component
__device__ __forceinline__ V3 scale(float s, V3 a) {
    return {mul(s, a.x), mul(s, a.y), mul(s, a.z)};
}
__device__ __forceinline__ V3 select(bool c, V3 a, V3 b) {
    return {c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return (mul(a.x, b.x) + mul(a.y, b.y)) + mul(a.z, b.z);
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {mul(a.y, b.z) - mul(a.z, b.y), mul(a.z, b.x) - mul(a.x, b.z),
            mul(a.x, b.y) - mul(a.y, b.x)};
}
// la.v3_normalize with or without eps = 1e-30: eps * eps is 0 in f32, so
// the clamp only passes a NaN on, which rsqrtf does too
__device__ __forceinline__ V3 normalize(V3 a) {
    return scale(rsqrtf(dot(a, a)), a);
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ float lerp(float a, float b, float r) {
    return a + mul(r, b - a);
}

// row r of a (3, N) output, lane i at p[r * n + i]
__device__ __forceinline__ void put3(float* p, long long n, int i, V3 v) {
    p[i] = v.x;
    p[n + i] = v.y;
    p[2 * n + i] = v.z;
}

// ---------------------------------------------------------------------------
// Lane operands whose lane axis may be strided or broadcast (stride 0)

struct Lanes {  // a (N,) operand: lane i at p[i * s]
    const void* p;
    long long s;
};
struct Lanes3 {  // a (3, N) operand: row r, lane i at p[r * rs + i * s]
    const float* p;
    long long rs, s;
};

template <typename T>
__device__ __forceinline__ T at(Lanes x, long long i) {
    return __ldg(static_cast<const T*>(x.p) + i * x.s);
}
__device__ __forceinline__ V3 at3(Lanes3 x, long long i) {
    const float* p = x.p + i * x.s;
    return {__ldg(p), __ldg(p + x.rs), __ldg(p + 2 * x.rs)};
}

// ---------------------------------------------------------------------------
// ops/shapes.triangle_t_v of one lane: whether the triangle (a, b, c) is hit
// at a t in (0, tmax); t as the test computed it (also on a miss) and the
// unnormalised normal n = e1 x e2

__device__ __forceinline__ bool triangle_t(float tmax, V3 o, V3 d, V3 a,
                                           V3 b, V3 c, float& t, V3& n) {
    const V3 e1 = b - a, e2 = c - a;
    n = cross(e1, e2);
    const float det = -dot(n, d);
    const bool nondeg = fabsf(det) >= kTriEps;
    const float inv_a = __fdiv_rn(nondeg ? 1.f : 0.f, nondeg ? det : 1.f);
    const V3 s = o - a;
    const V3 m = cross(s, d);
    t = mul(dot(n, s), inv_a);
    const float u = mul(dot(m, e2), inv_a);
    const float v = mul(-dot(m, e1), inv_a);
    return nondeg && u >= 0.f && v >= 0.f && u + v <= 1.f && t < tmax &&
           t > 0.f;
}

// ---------------------------------------------------------------------------
// ops/spectrum.lookup_pairs over six (wavelength, value) knots: knot k's
// wavelength at knots[2k * stride], its value at knots[(2k + 1) * stride]

__device__ __forceinline__ float lookup_pairs(float v, const float* knots,
                                              int stride) {
    float w_below = -1.f, x_below = 0.f, w_above = INFINITY, x_above = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        float wk = __ldg(knots + 2 * k * stride);
        float xk = __ldg(knots + (2 * k + 1) * stride);
        if (wk > w_below && wk <= v) {
            w_below = wk;
            x_below = xk;
        }
        if (wk < w_above && wk > v) {
            w_above = wk;
            x_above = xk;
        }
    }
    bool has_below = w_below >= 0.f, has_above = isfinite(w_above);
    float t = (v - w_below) / (w_above - w_below);
    float interp = x_below + mul(t, x_above - x_below);
    return has_below && has_above ? interp
           : has_below            ? x_below
           : has_above            ? x_above
                                  : 0.f;
}

// ---------------------------------------------------------------------------
// ops/rng.py

__device__ __forceinline__ uint32_t next_u32(uint32_t& s) {
    s = s * 747796405u + 2891336453u;
    uint32_t w = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
    return (w >> 22) ^ w;
}

__device__ __forceinline__ float next_unit(uint32_t& s) {
    return mul((float)(next_u32(s) >> 8), kUnitF);
}

}  // namespace
