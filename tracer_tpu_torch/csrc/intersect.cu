// Dense ray-triangle intersection kernels for Hopper (sm_90a).
//
// Both kernels test every ray against the triangles of a scene built by
// tracer_tpu_torch/ops/intersect.py:build_dense: per-triangle Moller
// coefficients (4, T_pad, 10) that are linear in the ray features
// phi = [d, o, o x d, 1] (10, N), walked in chunks of chunk_t triangles,
// each with its axis-aligned box (n_chunks, 8) = [min xyz, max xyz, 0, 0].
// Empty (padded) chunks carry an inverted +inf/-inf box.
//
// Design (the first, simple form): one thread per ray, 256 rays per block.
// The block walks the chunks in index order. For each chunk every live
// lane slab-tests the chunk box at its current bound (the rules of
// tracer_tpu/ops/pallas/intersect_kernel.py:_chunk_cull: d[k] == 0 always
// passes that axis, the far plane is inflated by 1 + AABB_EPS), and
// __syncthreads_or skips the chunk for the whole block when no lane can
// reach it. Otherwise the block stages the chunk's 4 * chunk_t * 10
// coefficients in shared memory (20 KB at chunk_t = 128, 40 KB at 256),
// and each lane evaluates a, n.s, m.e2, m.e1 as 10-term f32 dot products
// read by broadcast from shared memory, then the exact IEEE divide of the
// plain version (intersect.py:_chunk_scores_t). No fast math: nvcc may
// contract mul+add into FMA, so t differs from the plain version by a few
// ulps, never by the approximate reciprocal of the TPU kernel.
//
// What bounds it on an H100 is not yet measured. Not device memory: a
// lane reads 44 bytes of features and tmax and writes 8, and at one
// resident chunk (the Cornell box pads to a single 128-triangle chunk)
// it visits every triangle. Per lane and triangle it issues 40 FMAs, one
// IEEE divide and the validity tests, and reads the 40 coefficients by
// broadcast from shared memory. At the measured times that is well under
// the card's f32 peak, so the limit is one of shared-memory load issue,
// the divide's instruction sequence, or the serial FMA chains of the
// dot products at the achieved occupancy. Left for later work: the
// per-tile near-to-far chunk schedule (_tile_chunk_order), the boundary
// ray permutation, the superchunk walk, streaming of coefficients too
// large for shared memory, and wgmma/TMA staging of the score products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kTriEps = 0.00001f;   // shapes.TRI_EPS
constexpr float kAabbEps = 0.001f;    // shapes.AABB_EPS

__device__ __forceinline__ bool chunk_empty(const float* __restrict__ b) {
    return b[0] > b[3];
}

// Slab test of one ray against one chunk box at the bound `upper`.
__device__ __forceinline__ bool slab_may_hit(const float* p,
                                             const float* __restrict__ b,
                                             float upper) {
    float tmin = 0.0f;
    float tmx = upper;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float dk = p[k];
        const float ok = p[3 + k];
        const bool par = dk == 0.0f;
        const float inv = 1.0f / (par ? 1.0f : dk);
        const float t0 = (__ldg(b + k) - ok) * inv;
        const float t1 = (__ldg(b + 3 + k) - ok) * inv;
        const float lo = par ? 0.0f : fminf(t0, t1);
        const float hi = par ? upper : fmaxf(t0, t1) * (1.0f + kAabbEps);
        tmin = fmaxf(tmin, lo);
        tmx = fminf(tmx, hi);
    }
    return tmx > tmin;
}

// Copy chunk ci's coefficients, blocks (a, n.s, m.e2, m.e1), into shared
// memory as (4, chunk_t, 10).
__device__ __forceinline__ void stage_chunk(float* sh,
                                            const float* __restrict__ coeffs,
                                            int t_pad, int chunk_t, int ci) {
    const int per_block = chunk_t * 10;
    for (int idx = threadIdx.x; idx < 4 * per_block; idx += blockDim.x) {
        const int blk = idx / per_block;
        const int r = idx - blk * per_block;
        sh[idx] = __ldg(coeffs + (size_t)blk * t_pad * 10
                        + (size_t)ci * per_block + r);
    }
}

__device__ __forceinline__ float dot10(const float* __restrict__ c,
                                       const float* p) {
    float s = c[0] * p[0];
#pragma unroll
    for (int k = 1; k < 10; ++k) s += c[k] * p[k];
    return s;
}

// Moller scores of triangle j of the staged chunk: returns t (+inf when
// the triangle is not a valid hit below tmax), as intersect.py's
// _chunk_scores_t computes it.
__device__ __forceinline__ float triangle_t(const float* sh, int chunk_t,
                                            int j, const float* p,
                                            float tmax) {
    const int stride = chunk_t * 10;
    const float a = dot10(sh + j * 10, p);
    const float nt = dot10(sh + stride + j * 10, p);
    const float nu = dot10(sh + 2 * stride + j * 10, p);
    const float nv = dot10(sh + 3 * stride + j * 10, p);
    const bool nondeg = fabsf(a) >= kTriEps;
    const float inv_a = (nondeg ? 1.0f : 0.0f) / (nondeg ? a : 1.0f);
    const float t = nt * inv_a;
    const float u = nu * inv_a;
    const float v = -nv * inv_a;
    const bool valid = nondeg && (u >= 0.0f) && (v >= 0.0f)
                       && (u + v <= 1.0f) && (t > 0.0f) && (t < tmax);
    return valid ? t : __int_as_float(0x7f800000);
}

// Replaces tracer_tpu/ops/pallas/intersect_kernel.py:_closest_kernel
// (closest_hit_pallas): per ray the closest valid triangle below tmax.
// best_t is +inf and best_i 0 on a miss; ties keep the lowest storage
// index, as argmin plus the strict < merge of the plain version do.
__global__ void __launch_bounds__(kBlock)
closest_hit_kernel(const float* __restrict__ coeffs,
                   const float* __restrict__ phi,
                   const float* __restrict__ tmax,
                   const float* __restrict__ bounds,
                   int n, int t_pad, int n_chunks, int chunk_t,
                   float* __restrict__ best_t, int32_t* __restrict__ best_i) {
    extern __shared__ float sh[];
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = lane < n;
    float p[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) p[k] = active ? __ldg(phi + (size_t)k * n + lane) : 0.0f;
    const float tm = active ? __ldg(tmax + lane) : 0.0f;
    float bt = __int_as_float(0x7f800000);
    int bi = 0;

    for (int ci = 0; ci < n_chunks; ++ci) {
        const float* b = bounds + ci * 8;
        if (chunk_empty(b)) continue;  // uniform across the block
        const bool may = active && slab_may_hit(p, b, fminf(tm, bt));
        // also the barrier that ends every read of the previous chunk
        if (!__syncthreads_or(may)) continue;
        stage_chunk(sh, coeffs, t_pad, chunk_t, ci);
        __syncthreads();
        if (active) {
            for (int j = 0; j < chunk_t; ++j) {
                const float t = triangle_t(sh, chunk_t, j, p, tm);
                if (t < bt) {
                    bt = t;
                    bi = ci * chunk_t + j;
                }
            }
        }
    }
    if (active) {
        best_t[lane] = bt;
        best_i[lane] = bi;
    }
}

// Replaces tracer_tpu/ops/pallas/intersect_kernel.py:_any_kernel
// (any_hit_pallas): per ray whether any valid triangle lies below tmax.
// A lane with tmax <= 0 does nothing; a lane stops at its first hit.
__global__ void __launch_bounds__(kBlock)
any_hit_kernel(const float* __restrict__ coeffs,
               const float* __restrict__ phi,
               const float* __restrict__ tmax,
               const float* __restrict__ bounds,
               int n, int t_pad, int n_chunks, int chunk_t,
               uint8_t* __restrict__ hit) {
    extern __shared__ float sh[];
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const float tm = lane < n ? __ldg(tmax + lane) : 0.0f;
    const bool live = lane < n && tm > 0.0f;
    float p[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) p[k] = live ? __ldg(phi + (size_t)k * n + lane) : 0.0f;
    bool found = false;

    for (int ci = 0; ci < n_chunks; ++ci) {
        const float* b = bounds + ci * 8;
        if (chunk_empty(b)) continue;
        const bool may = live && !found && slab_may_hit(p, b, tm);
        if (!__syncthreads_or(may)) continue;
        stage_chunk(sh, coeffs, t_pad, chunk_t, ci);
        __syncthreads();
        if (live && !found) {
            for (int j = 0; j < chunk_t; ++j) {
                if (triangle_t(sh, chunk_t, j, p, tm) < __int_as_float(0x7f800000)) {
                    found = true;
                    break;
                }
            }
        }
    }
    if (lane < n) hit[lane] = found ? 1 : 0;
}

size_t chunk_smem_bytes(int chunk_t) {
    return (size_t)4 * chunk_t * 10 * sizeof(float);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int closest_hit_launch(const float* coeffs, const float* phi,
                       const float* tmax, const float* bounds, int n,
                       int t_pad, int n_chunks, int chunk_t, float* best_t,
                       int32_t* best_i, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int grid = (n + kBlock - 1) / kBlock;
    closest_hit_kernel<<<grid, kBlock, chunk_smem_bytes(chunk_t), (cudaStream_t)stream>>>(
        coeffs, phi, tmax, bounds, n, t_pad, n_chunks, chunk_t, best_t,
        best_i);
    return (int)cudaGetLastError();
}

int any_hit_launch(const float* coeffs, const float* phi, const float* tmax,
                   const float* bounds, int n, int t_pad, int n_chunks,
                   int chunk_t, uint8_t* hit, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int grid = (n + kBlock - 1) / kBlock;
    any_hit_kernel<<<grid, kBlock, chunk_smem_bytes(chunk_t), (cudaStream_t)stream>>>(
        coeffs, phi, tmax, bounds, n, t_pad, n_chunks, chunk_t, hit);
    return (int)cudaGetLastError();
}

}  // extern "C"
