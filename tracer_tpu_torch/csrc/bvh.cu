// The LBVH walk, for Hopper (sm_90a): K14 and K15.
//
//   lbvh_closest_kernel   one thread a lane: the closest hit of its ray
//                         below its tmax, the winning leaf (Morton order)
//                         and its t
//   lbvh_any_kernel       one thread a lane: whether any leaf is hit below
//                         tmax; the lane stops at its first hit
//
// They replace no TPU kernel: the JAX package walks the LBVH in XLA
// (tracer_tpu/ops/bvh.py), as the reference does in Futhark (bvh.fut). The
// plain version is ops/bvh._traverse, which steps every lane at once, ~30
// passes over the lanes a step with a host read every 8th step; a lane here
// walks on its own until it leaves the tree.
//
// The walk is the plain version's, step for step: the stackless
// parent-pointer walk of the Karras tree (ops/radix_tree.py's pointers:
// [0, I) internal, [I, I + n) leaf). A step at an internal node takes its
// left child when it came from the parent (prev is the node itself, or -1
// at the root) and the ray enters the node's box below the lane's tmax;
// its right child when it came back from the left child; else it goes up
// to the parent. A leaf child is tested in the same step and the cursor
// stays on the node. The closest walk lowers tmax at each hit, so a tie in
// t keeps the leaf met first, as the plain version's does.
//
// Arithmetic: f32 as the plain version's PyTorch ops compute it on the
// card (csrc/torch_f32.cuh): the slab test of shapes.hit_aabb_v (1 / d as
// an IEEE divide; t0, t1 a difference and a product; the exit scaled by
// 1 + AABB_EPS; a NaN misses) and the Moller test of shapes.triangle_t_v
// (each product __fmul_rn, dot products summed x + y first, an IEEE
// divide), so that every lane's leaf and t, or hit flag, equal the plain
// version's bit for bit. No FMA contraction of separately rounded ops, no
// TF32.
//
// Bound: bytes. A lane reads its ray and tmax and writes its answer; the
// tree is read where the rays enter it, at least every triangle once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_f32.cuh"

namespace {

constexpr int kLbvhBlock = 128;
constexpr float kAabbScale = (float)(1.0 + 0.001);  // 1 + shapes.AABB_EPS

struct LbvhArgs {
    const float* node_min;   // (I, 3)
    const float* node_max;   // (I, 3)
    const int* left;         // (I,)
    const int* right;        // (I,)
    const int* parent;       // (I,), -1 at the root
    const float* tris;       // (n, 3, 3), Morton order
    const float* tmax;       // (N,)
    const float* o;          // (3, N)
    const float* d;          // (3, N)
    long long lanes;
    int n_int;               // I; leaf pointers are I + leaf index
    long long max_steps;
};

// torch.minimum / torch.maximum: a NaN on either side gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
    return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// shapes.hit_aabb_v of internal node k
__device__ __forceinline__ bool hit_box(const LbvhArgs& a, int k, float tmax,
                                        V3 o, V3 inv_d) {
    const float* mn = a.node_min + 3 * (long long)k;
    const float* mx = a.node_max + 3 * (long long)k;
    float lo[3], hi[3];
    const float oo[3] = {o.x, o.y, o.z}, id[3] = {inv_d.x, inv_d.y, inv_d.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float t0 = mul(__ldg(mn + c) - oo[c], id[c]);
        const float t1 = mul(__ldg(mx + c) - oo[c], id[c]);
        lo[c] = nan_min(t0, t1);
        hi[c] = mul(nan_max(t0, t1), kAabbScale);
    }
    const float tmin = clamp_min(nan_max(nan_max(lo[0], lo[1]), lo[2]), 0.f);
    const float tmx = nan_min(nan_min(nan_min(hi[0], hi[1]), hi[2]), tmax);
    return tmx > tmin;
}

// shapes.triangle_t_v of leaf li: whether it is hit in (0, tmax), and t
__device__ __forceinline__ bool hit_leaf(const LbvhArgs& a, int li,
                                         float tmax, V3 o, V3 d, float& t) {
    const float* p = a.tris + 9 * (long long)li;
    const V3 ta = {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
    const V3 tb = {__ldg(p + 3), __ldg(p + 4), __ldg(p + 5)};
    const V3 tc = {__ldg(p + 6), __ldg(p + 7), __ldg(p + 8)};
    V3 n;
    return triangle_t(tmax, o, d, ta, tb, tc, t, n);
}

__device__ __forceinline__ V3 ray3(const float* p, long long n, long long i) {
    return {__ldg(p + i), __ldg(p + n + i), __ldg(p + 2 * n + i)};
}

// One lane's walk: the leaf it takes (-1: none) and its tmax after it
// (closest), or whether it hit (any).
template <bool kAny>
__device__ __forceinline__ void walk(const LbvhArgs& a, long long i,
                                     int& best, float& tmax, bool& hit) {
    const V3 o = ray3(a.o, a.lanes, i), d = ray3(a.d, a.lanes, i);
    const V3 inv_d = {__fdiv_rn(1.f, d.x), __fdiv_rn(1.f, d.y),
                      __fdiv_rn(1.f, d.z)};
    tmax = __ldg(a.tmax + i);
    best = -1;
    hit = false;
    int cur = 0, prev = -1;
    for (long long step = 0; cur != -1 && step < a.max_steps; ++step) {
        const int l = __ldg(a.left + cur), r = __ldg(a.right + cur);
        const bool from_left = prev == l;
        const bool has_child =
            from_left || (prev != r && hit_box(a, cur, tmax, o, inv_d));
        if (!has_child) {
            prev = cur;
            cur = __ldg(a.parent + cur);
            continue;
        }
        const int child = from_left ? r : l;
        if (child < a.n_int) {       // descend
            cur = child;
            prev = child;
            continue;
        }
        const int li = child - a.n_int;
        float t;
        if (hit_leaf(a, li, tmax, o, d, t)) {
            if (kAny) {
                hit = true;
                return;
            }
            best = li;
            tmax = t;
        }
        prev = child;                 // stay for the right child, or up
    }
}

__global__ void __launch_bounds__(kLbvhBlock)
    lbvh_closest_kernel(LbvhArgs a, long long* leaf, float* t_out) {
    const long long i = (long long)blockIdx.x * kLbvhBlock + threadIdx.x;
    if (i >= a.lanes) return;
    int best;
    float tmax;
    bool hit;
    walk<false>(a, i, best, tmax, hit);
    leaf[i] = best;
    t_out[i] = tmax;
}

__global__ void __launch_bounds__(kLbvhBlock)
    lbvh_any_kernel(LbvhArgs a, bool* hit_out) {
    const long long i = (long long)blockIdx.x * kLbvhBlock + threadIdx.x;
    if (i >= a.lanes) return;
    int best;
    float tmax;
    bool hit;
    walk<true>(a, i, best, tmax, hit);
    hit_out[i] = hit;
}

LbvhArgs lbvh_args(const void* const* ptr, const long long* in) {
    LbvhArgs a;
    a.node_min = static_cast<const float*>(ptr[0]);
    a.node_max = static_cast<const float*>(ptr[1]);
    a.left = static_cast<const int*>(ptr[2]);
    a.right = static_cast<const int*>(ptr[3]);
    a.parent = static_cast<const int*>(ptr[4]);
    a.tris = static_cast<const float*>(ptr[5]);
    a.tmax = static_cast<const float*>(ptr[6]);
    a.o = static_cast<const float*>(ptr[7]);
    a.d = static_cast<const float*>(ptr[8]);
    a.lanes = in[0];
    a.n_int = (int)in[1];
    a.max_steps = in[2];
    return a;
}

dim3 lbvh_grid(long long lanes) {
    return dim3((unsigned)((lanes + kLbvhBlock - 1) / kLbvhBlock));
}

}  // namespace

extern "C" {

// ptr: node_min, node_max, left, right, parent, tris, tmax, o, d, then the
// outputs: leaf (int64) and t (closest) or hit (bool, any); in: lanes N,
// internal nodes I, the most steps a lane takes. N == 0 launches nothing.
int lbvh_closest_launch(const void* const* ptr, const long long* in,
                        int n_ptr, int n_int, void* stream) {
    if (n_ptr != 11 || n_int != 3) return (int)cudaErrorInvalidValue;
    const LbvhArgs a = lbvh_args(ptr, in);
    if (a.lanes <= 0) return 0;
    lbvh_closest_kernel<<<lbvh_grid(a.lanes), kLbvhBlock, 0,
                          (cudaStream_t)stream>>>(
        a, static_cast<long long*>(const_cast<void*>(ptr[9])),
        static_cast<float*>(const_cast<void*>(ptr[10])));
    return (int)cudaGetLastError();
}

int lbvh_any_launch(const void* const* ptr, const long long* in, int n_ptr,
                    int n_int, void* stream) {
    if (n_ptr != 10 || n_int != 3) return (int)cudaErrorInvalidValue;
    const LbvhArgs a = lbvh_args(ptr, in);
    if (a.lanes <= 0) return 0;
    lbvh_any_kernel<<<lbvh_grid(a.lanes), kLbvhBlock, 0,
                      (cudaStream_t)stream>>>(
        a, static_cast<bool*>(const_cast<void*>(ptr[9])));
    return (int)cudaGetLastError();
}

}  // extern "C"
