// f32 and the rng as the port's plain PyTorch versions compute them on the
// card, for the kernels held to them bit for bit (csrc/shade.cu K6/K7,
// csrc/refill.cu K13): each product __fmul_rn, so that no multiply and add
// contract into an FMA that rounds once where two PyTorch ops round twice;
// clamp_min and clamp pass NaN on as PyTorch's do; the PCG chain of
// ops/rng.py in uint32, over the int64 words the pool keeps in [0, 2^32).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kUnitF = (float)(0.9999 / 16777216.0);   // rng._UNIT_F

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
