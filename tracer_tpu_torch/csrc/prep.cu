// The preparation of a sorted query for Hopper (sm_90a): everything that
// runs between the ray features and the launch of K1-K4.
//
//   lane_key_kernel     each lane's coherence key (ops/intersect.py
//                       perm_key), -1 for a dead lane, and the count of
//                       dead lanes                                     (K8)
//   lane_deal_kernel    the dead-first deal of the sorted lanes over
//                       SPREAD_WARPS warps (lane_order's tail) and the
//                       gather of phi and tmax into the dealt order     (K9)
//   superchunk_kernel   ops/intersect_kernel.py superchunk_bounds       (K10)
//   schedule_kernel     tile_chunk_order: per tile of lanes the
//                       near-to-far order of the (super)chunks and how
//                       many any lane of the tile reaches               (K11)
//   heavy_first_kernel  heavy_first: the tiles by that count, descending,
//                       stable                                          (K12)
//
// They replace no TPU kernel: the JAX package leaves the same functions to
// XLA (tracer_tpu/ops/intersect.py:321 _perm_key and the permutation
// around it, tracer_tpu/ops/pallas/intersect_kernel.py:309
// _superchunk_bounds and :329 _tile_chunk_order), which fuses them. Eager
// PyTorch ran them as ~1,100 elementwise passes a bounce over (superchunks,
// lanes) temporaries, each a launch from the host. Between K8 and K9 the
// stable sort of the int32 keys stays one library call (torch.sort), as the
// JAX package leaves its argsort to XLA.
//
// Bound: bytes for K8 and K9 (32 and 104 B a lane: the features, tmax, the
// key, the sorted index, the dealt index and the gathered features), the
// slab tests for K11 (per lane and box ~24 flops, 24 B of features and tmax
// a lane read once; the tile's boxes sit in shared memory); K10 and K12 are
// a few microseconds of one small grid.
//
// Exactness: the plain versions' f32 steps as PyTorch's elementwise ops
// round them on the card. Each difference and product is __fsub_rn /
// __fmul_rn, so that nothing contracts into an FMA; a divide is IEEE
// (1 / d is PyTorch's reciprocal); minimum, maximum and clamp carry NaN on
// as PyTorch's do, and the float-to-int conversion truncates as its cast
// does. The order of the boxes is a stable rank under PyTorch's sort
// comparison (NaN after +inf, -0 equal to +0), so key, dealt index, order,
// count and tile order equal the plain versions' bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSched = 64;          // intersect_kernel.MAX_SCHED
constexpr int kKeyBlock = 256;         // lanes per block of K8 and K9
constexpr int kHeavyThreads = 1024;    // K12's one block
constexpr int kWarp = 32;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxTileWarps = 32;      // K11: at most 1024 lanes a tile

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// torch.clamp with float bounds: NaN passes.
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// The comparison of PyTorch's sort: NaN after everything else.
__device__ __forceinline__ bool sort_less(float a, float b) {
    return (isnan(b) && !isnan(a)) || a < b;
}

// ---------------------------------------------------------------------------
// K8: the key

// intersect._spread3: bit i of v to bit 3i.
__device__ __forceinline__ int32_t spread3(int32_t v, int bits) {
    int32_t r = 0;
    for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1) << (3 * i);
    return r;
}

// intersect._quant_i: (v - lo) * (2^bits / max(hi - lo, 1e-30)), clamped
// to the cells and truncated.
__device__ __forceinline__ int32_t quant(float v, float lo, float hi,
                                         int bits) {
    const float range = __fsub_rn(hi, lo);
    const float scale = __fdiv_rn((float)(1 << bits),
                                  isnan(range) ? range : fmaxf(range, 1e-30f));
    const float q = __fmul_rn(__fsub_rn(v, lo), scale);
    return (int32_t)clamp_f(q, 0.0f, (float)((1 << bits) - 1));
}

__device__ __forceinline__ int32_t morton3(const float* v, const float* lo,
                                           const float* hi, int bits) {
    return (spread3(quant(v[0], lo[0], hi[0], bits), bits) << 2)
           | (spread3(quant(v[1], lo[1], hi[1], bits), bits) << 1)
           | spread3(quant(v[2], lo[2], hi[2], bits), bits);
}

// mode: the index in intersect.PERM_KEYS (0 oct, 1 dmorton, 2 odmorton);
// box: the scene's [lo xyz, hi xyz]. With dead_first a lane whose tmax is
// not > 0 keys -1 and counts into *n_dead (zeroed by the launcher).
__global__ void __launch_bounds__(kKeyBlock) lane_key_kernel(
        const float* __restrict__ phi, long long s0, long long s1,
        const float* __restrict__ tmax, long long ts,
        const float* __restrict__ box, int n, int mode, int dead_first,
        int32_t* __restrict__ key, int32_t* __restrict__ n_dead) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = i < n;
    bool dead = false;
    if (in) {
        float d[3], o[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            d[k] = __ldg(phi + k * s0 + i * s1);
            o[k] = __ldg(phi + (3 + k) * s0 + i * s1);
        }
        const float unit_lo[3] = {-1.0f, -1.0f, -1.0f};
        const float unit_hi[3] = {1.0f, 1.0f, 1.0f};
        int32_t kv;
        if (mode == 0) {
            kv = (d[0] >= 0.0f) * 4 + (d[1] >= 0.0f) * 2 + (d[2] >= 0.0f);
        } else if (mode == 1) {
            kv = morton3(d, unit_lo, unit_hi, 10);
        } else {
            const float lo[3] = {__ldg(box), __ldg(box + 1), __ldg(box + 2)};
            const float hi[3] = {__ldg(box + 3), __ldg(box + 4),
                                 __ldg(box + 5)};
            kv = (morton3(o, lo, hi, 5) << 15)
                 | morton3(d, unit_lo, unit_hi, 5);
        }
        dead = dead_first && !(__ldg(tmax + i * ts) > 0.0f);
        key[i] = dead ? -1 : kv;
    }
    const int block_dead = __syncthreads_count(dead);
    if (threadIdx.x == 0 && block_dead) atomicAdd(n_dead, block_dead);
}

// ---------------------------------------------------------------------------
// K9: the deal and the gather

// Sorted position p (dead lanes first, each group in key order) goes to
// dest(p), the position lane_order's second sort gives it: with L live and
// D dead lanes and k = clamp(ceil(L / spread), 1, 32), live rank j goes to
// min(before(j), D) + j, before(j) = floor(j / k) * (32 - k) (D at k = 32),
// and dead rank r to r + min(L, k * (floor(r / (32 - k)) + 1)) (r at k =
// 32). spread = 0 keeps the sorted order.
__global__ void __launch_bounds__(kKeyBlock) lane_deal_kernel(
        const int64_t* __restrict__ idx, const int32_t* __restrict__ n_dead,
        const float* __restrict__ phi, long long s0, long long s1,
        const float* __restrict__ tmax, long long ts, int n, int spread,
        int64_t* __restrict__ order, float* __restrict__ phi_out,
        float* __restrict__ tmax_out) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    long long dest = p;
    if (spread > 0) {
        const long long nd = __ldg(n_dead);
        const long long live = n - nd;
        long long k = (live + spread - 1) / spread;
        k = k < 1 ? 1 : (k > kWarp ? kWarp : k);
        if (p >= nd) {
            const long long j = p - nd;
            const long long before = k == kWarp ? nd : (j / k) * (kWarp - k);
            dest = (before < nd ? before : nd) + j;
        } else if (k < kWarp) {
            const long long ahead = k * (p / (kWarp - k) + 1);
            dest = p + (ahead < live ? ahead : live);
        }
    }
    const long long src = idx[p];
    order[dest] = src;
#pragma unroll
    for (int r = 0; r < 10; ++r)
        phi_out[r * (long long)n + dest] = __ldg(phi + r * s0 + src * s1);
    tmax_out[dest] = __ldg(tmax + src * ts);
}

// ---------------------------------------------------------------------------
// K10: superchunk boxes

// One thread per output value: the min (columns 0-2) or max (3-5) over the
// g member chunks, members past n_chunks being empty (+inf / -inf) boxes;
// columns 6-7 are 0.
__global__ void superchunk_kernel(const float* __restrict__ bounds,
                                  int n_chunks, int g, int n_super,
                                  float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_super * 8) return;
    const int s = e / 8, c = e % 8;
    if (c >= 6) {
        out[e] = 0.0f;
        return;
    }
    const bool lo = c < 3;
    float acc = lo ? inf_f() : -inf_f();
    for (int m = 0; m < g; ++m) {
        const int ci = s * g + m;
        if (ci >= n_chunks) break;
        const float v = __ldg(bounds + (long long)ci * 8 + c);
        acc = lo ? min_nan(acc, v) : max_nan(acc, v);
    }
    out[e] = acc;
}

// ---------------------------------------------------------------------------
// K11: the per-tile schedule

// One block per tile of blockDim.x lanes, one thread per lane (lanes past n
// have phi = 0 and tmax = 0, as the plain version pads them, and reach
// nothing). For each of the n_box boxes: the lane's slab entry at its tmax
// (_tile_entry: d[k] == 0 always passes axis k, the far plane is scaled by
// `far`, f32(1 + AABB_EPS), an inverted box is never entered), +inf where
// it does not enter; the tile's minimum by warp shuffles, then over the
// warps in shared memory. The keys' stable rank gives the order row, the
// finite keys the count.
__global__ void schedule_kernel(const float* __restrict__ phi, long long s0,
                                long long s1, const float* __restrict__ tmax,
                                long long ts, int n,
                                const float* __restrict__ boxes, int n_box,
                                float far, int32_t* __restrict__ order,
                                int32_t* __restrict__ count) {
    __shared__ float box[kMaxSched][6];
    __shared__ float warp_min[kMaxTileWarps][kMaxSched];
    __shared__ float key[kMaxSched];
    const int tid = threadIdx.x;
    const long long lane = (long long)blockIdx.x * blockDim.x + tid;
    for (int e = tid; e < n_box * 6; e += blockDim.x)
        box[e / 6][e % 6] = __ldg(boxes + (e / 6) * 8 + e % 6);
    float o[3], inv[3];
    bool par[3];
    float tm = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float d = lane < n ? __ldg(phi + k * s0 + lane * s1) : 0.0f;
        o[k] = lane < n ? __ldg(phi + (3 + k) * s0 + lane * s1) : 0.0f;
        par[k] = d == 0.0f;
        inv[k] = __fdiv_rn(1.0f, par[k] ? 1.0f : d);
    }
    if (lane < n) tm = __ldg(tmax + lane * ts);
    __syncthreads();
    const int warp = tid / kWarp, wl = tid % kWarp;
    for (int b = 0; b < n_box; ++b) {
        float tmin = 0.0f, tmx = tm;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float t0 = __fmul_rn(__fsub_rn(box[b][k], o[k]), inv[k]);
            const float t1 = __fmul_rn(__fsub_rn(box[b][3 + k], o[k]), inv[k]);
            tmin = max_nan(tmin, par[k] ? 0.0f : min_nan(t0, t1));
            tmx = min_nan(tmx, par[k] ? tm : __fmul_rn(max_nan(t0, t1), far));
        }
        // tmx > tmin fails on NaN, so an entry is never NaN
        float e = (tmx > tmin && !(box[b][0] > box[b][3])) ? tmin : inf_f();
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2)
            e = fminf(e, __shfl_xor_sync(kFullWarp, e, off));
        if (wl == 0) warp_min[warp][b] = e;
    }
    __syncthreads();
    const int n_warps = blockDim.x / kWarp;
    for (int b = tid; b < n_box; b += blockDim.x) {
        float m = warp_min[0][b];
        for (int w = 1; w < n_warps; ++w) m = fminf(m, warp_min[w][b]);
        key[b] = m;
    }
    __syncthreads();
    int32_t* row = order + (long long)blockIdx.x * n_box;
    for (int b = tid; b < n_box; b += blockDim.x) {
        const float kb = key[b];
        int rank = 0;
        for (int c = 0; c < n_box; ++c) {
            const float kc = key[c];
            rank += c < b ? !sort_less(kb, kc) : sort_less(kc, kb);
        }
        row[rank] = b;
    }
    if (tid == 0) {
        int finite = 0;
        for (int b = 0; b < n_box; ++b) finite += isfinite(key[b]);
        count[blockIdx.x] = finite;
    }
}

// ---------------------------------------------------------------------------
// K12: the tiles, longest schedule first

// One block: a histogram of the counts (0..n_box), the descending starts,
// then the tiles placed 1,024 at a time in index order, each after the
// earlier tiles of its count (its warp's by __match_any_sync, the earlier
// warps' by their per-count tallies): a stable counting sort.
__global__ void __launch_bounds__(kHeavyThreads) heavy_first_kernel(
        const int32_t* __restrict__ count, int n_tiles, int n_box,
        int32_t* __restrict__ tiles) {
    __shared__ int start[kMaxSched + 1];
    __shared__ int tally[kHeavyThreads / kWarp][kMaxSched + 1];
    const int tid = threadIdx.x, warp = tid / kWarp, wl = tid % kWarp;
    const int n_warps = blockDim.x / kWarp;
    for (int v = tid; v <= n_box; v += blockDim.x) start[v] = 0;
    __syncthreads();
    for (int t = tid; t < n_tiles; t += blockDim.x)
        atomicAdd(&start[__ldg(count + t)], 1);
    __syncthreads();
    if (tid == 0) {
        int run = 0;
        for (int v = n_box; v >= 0; --v) {
            const int h = start[v];
            start[v] = run;
            run += h;
        }
    }
    for (int base = 0; base < n_tiles; base += blockDim.x) {
        for (int v = wl; v <= n_box; v += kWarp) tally[warp][v] = 0;
        __syncthreads();
        const int t = base + tid;
        const int v = t < n_tiles ? __ldg(count + t) : -1;
        const unsigned same = __match_any_sync(kFullWarp, v);
        const int ahead = __popc(same & ((1u << wl) - 1u));
        if (v >= 0 && ahead == 0) tally[warp][v] = __popc(same);
        __syncthreads();
        if (v >= 0) {
            int pos = start[v] + ahead;
            for (int w = 0; w < warp; ++w) pos += tally[w][v];
            tiles[pos] = t;
        }
        __syncthreads();
        for (int u = tid; u <= n_box; u += blockDim.x) {
            int s = 0;
            for (int w = 0; w < n_warps; ++w) s += tally[w][u];
            start[u] += s;
        }
        __syncthreads();   // before the next round clears the tallies
    }
}

}  // namespace

extern "C" {

// The most schedule entries a tile takes (intersect_kernel.MAX_SCHED,
// checked at load).
int prep_max_sched() { return kMaxSched; }

// Each entry point launches on `stream` and returns 0 or a cudaError_t.
// Strides are in elements; a stride of 0 broadcasts a scalar.

// ptr: phi, tmax, box, key, n_dead; in: phi's strides (row, lane), tmax's,
// n, mode, dead_first.
int lane_key_launch(const void* const* ptr, const long long* in, int n_ptr,
                    int n_int, void* stream) {
    if (n_ptr != 5 || n_int != 6) return (int)cudaErrorInvalidValue;
    const int n = (int)in[3], mode = (int)in[4];
    if (n < 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    int32_t* n_dead = (int32_t*)ptr[4];
    cudaError_t err = cudaMemsetAsync(n_dead, 0, sizeof(int32_t),
                                      (cudaStream_t)stream);
    if (err != cudaSuccess || n == 0) return (int)err;
    lane_key_kernel<<<(n + kKeyBlock - 1) / kKeyBlock, kKeyBlock, 0,
                      (cudaStream_t)stream>>>(
        (const float*)ptr[0], in[0], in[1], (const float*)ptr[1], in[2],
        (const float*)ptr[2], n, mode, (int)in[5], (int32_t*)ptr[3], n_dead);
    return (int)cudaGetLastError();
}

// ptr: idx, n_dead, phi, tmax, order, phi_out, tmax_out; in: phi's strides,
// tmax's, n, spread.
int lane_deal_launch(const void* const* ptr, const long long* in, int n_ptr,
                     int n_int, void* stream) {
    if (n_ptr != 7 || n_int != 5) return (int)cudaErrorInvalidValue;
    const int n = (int)in[3], spread = (int)in[4];
    if (n < 0 || spread < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    lane_deal_kernel<<<(n + kKeyBlock - 1) / kKeyBlock, kKeyBlock, 0,
                       (cudaStream_t)stream>>>(
        (const int64_t*)ptr[0], (const int32_t*)ptr[1], (const float*)ptr[2],
        in[0], in[1], (const float*)ptr[3], in[2], n, spread,
        (int64_t*)ptr[4], (float*)ptr[5], (float*)ptr[6]);
    return (int)cudaGetLastError();
}

// ptr: bounds, out; in: n_chunks, g, n_super.
int superchunk_launch(const void* const* ptr, const long long* in, int n_ptr,
                      int n_int, void* stream) {
    if (n_ptr != 2 || n_int != 3) return (int)cudaErrorInvalidValue;
    const int n_chunks = (int)in[0], g = (int)in[1], n_super = (int)in[2];
    if (n_chunks <= 0 || g <= 0 || n_super != (n_chunks + g - 1) / g)
        return (int)cudaErrorInvalidValue;
    const int total = n_super * 8;
    superchunk_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const float*)ptr[0], n_chunks, g, n_super, (float*)ptr[1]);
    return (int)cudaGetLastError();
}

// ptr: phi, tmax, boxes, order, count; in: phi's strides, tmax's, n,
// tile_n, n_box, the IEEE bits of the far-plane scale f32(1 + AABB_EPS).
// tile_n lanes a tile (a multiple of 32, at most 1,024), n_box boxes (1 ..
// kMaxSched); order (ceil(n / tile_n), n_box), count (ceil(n / tile_n),).
int schedule_launch(const void* const* ptr, const long long* in, int n_ptr,
                    int n_int, void* stream) {
    if (n_ptr != 5 || n_int != 7) return (int)cudaErrorInvalidValue;
    const int n = (int)in[3], tile_n = (int)in[4], n_box = (int)in[5];
    if (n < 0 || tile_n < kWarp || tile_n % kWarp
        || tile_n > kWarp * kMaxTileWarps || n_box < 1 || n_box > kMaxSched)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t bits = (uint32_t)in[6];
    float far;
    memcpy(&far, &bits, sizeof far);
    const int n_tiles = (int)(((long long)n + tile_n - 1) / tile_n);
    schedule_kernel<<<n_tiles, tile_n, 0, (cudaStream_t)stream>>>(
        (const float*)ptr[0], in[0], in[1], (const float*)ptr[1], in[2], n,
        (const float*)ptr[2], n_box, far, (int32_t*)ptr[3],
        (int32_t*)ptr[4]);
    return (int)cudaGetLastError();
}

// ptr: count (n_tiles,) in 0..n_box, tiles (n_tiles,); in: n_tiles, n_box.
int heavy_first_launch(const void* const* ptr, const long long* in,
                       int n_ptr, int n_int, void* stream) {
    if (n_ptr != 2 || n_int != 2) return (int)cudaErrorInvalidValue;
    const int n_tiles = (int)in[0], n_box = (int)in[1];
    if (n_tiles < 0 || n_box < 0 || n_box > kMaxSched)
        return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    heavy_first_kernel<<<1, kHeavyThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ptr[0], n_tiles, n_box, (int32_t*)ptr[1]);
    return (int)cudaGetLastError();
}

}  // extern "C"
