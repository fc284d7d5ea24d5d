// Dense ray-triangle intersection kernels for Hopper (sm_90a).
//
// All four kernels test rays against the triangles of a scene built by
// tracer_tpu_torch/ops/intersect.py:build_dense: per-triangle Moller
// coefficients (4, T_pad, 10) that are linear in the ray features
// phi = [d, o, o x d, 1] (10, N), grouped in chunks of chunk_t morton-
// consecutive triangles, each with its axis-aligned box (n_chunks, 8) =
// [min xyz, max xyz, 0, 0]. Empty (padded) chunks carry an inverted
// +inf/-inf box.
//
//   closest_hit_kernel           replaces _closest_kernel          (K1)
//   closest_hit_streamed_kernel  replaces _closest_kernel_streamed (K2)
//   any_hit_kernel               replaces _any_kernel              (K3)
//   any_hit_streamed_kernel      replaces _any_kernel_streamed     (K4)
// all in tracer_tpu/ops/pallas/intersect_kernel.py.
//
// One thread owns one ray; a block of kBlock = 256 lanes is the TPU
// kernel's ray tile. The block walks its own near-to-far schedule,
// order[blockIdx.x, :count[blockIdx.x]] (ops/intersect_kernel.py:
// tile_chunk_order, built per block of kBlock lanes), whose entries are
// superchunks of g morton-consecutive chunks (g = 1: single chunks). A
// null schedule walks every superchunk in index order. At g > 1 the walk
// is two-level, as in the TPU kernels: the superchunk's union box is
// slab-tested at each lane's current bound and __syncthreads_or skips all
// g members when no lane can reach it; then each member chunk is culled
// the same way. The cull follows _chunk_cull: d[k] == 0 always passes that
// axis, the far plane is inflated by 1 + AABB_EPS, inverted boxes are
// skipped outright. The cull acts only through the block-wide skip: a lane
// whose own test fails still scans a chunk its neighbours need. A lane with
// a NaN feature or tmax can hit nothing and takes no part in the walk: the
// TPU kernel's min/max carry the NaN into its slab test, which then fails,
// whereas fminf/fmaxf here would drop it and pass every box.
//
// Resident kernels (K1, K3) stage each chunk they visit synchronously in
// shared memory (4 * chunk_t * 10 f32, 40 KB at chunk_t = 256). Streamed
// kernels (K2, K4) keep two such slots (80 KB, dynamic shared memory above
// the 48 KB default, so the launcher raises the kernel's limit first) and
// copy chunk r+1 with cp.async in 16-byte pieces while chunk r is scanned,
// in the order of the TPU kernels: decide block-wide whether chunk r+1 may
// be hit at the current bound, issue its copy if so, then wait for chunk
// r and scan it if its own copy was issued. There is no re-cull at visit
// time: bounds only shrink, so a chunk that passed at prefetch time is
// scanned, and one that failed would fail again. At g > 1 the pipeline
// restarts for each superchunk that passes its union-box test.
//
// Per lane and triangle a scan evaluates a, n.s, m.e2, m.e1 as 10-term
// f32 dot products, reading the coefficients by broadcast from shared
// memory, then the exact IEEE divide of the plain version
// (intersect_kernel.py:_chunk_scores). No fast math: nvcc may contract
// mul+add into FMA, so t differs from the plain version by a few ulps.
// The merge is a strict <, so within one chunk the lowest index wins a
// tie; across chunks an exact-t tie goes to the chunk visited first.
//
// What bounds the kernels on an H100 is not measured (Nsight Compute does
// not run where the card is). A lane reads 44 bytes of features and tmax
// and writes 8; each visited chunk costs the block 40 KB of coefficient
// reads, from L2 for the 14.4 MB of a 90k-triangle scene. Per lane and
// triangle the scan issues 40 FMAs, one divide and the validity tests on
// 40 broadcast shared-memory loads, so the candidates are shared-memory
// load issue, the divide and the serial FMA chains; the schedule and the
// culls decide how many chunks a block scans at all. Streaming hides the
// copy of the next chunk behind the scan of the current one; wgmma/TMA
// staging of the score products is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kTriEps = 0.00001f;   // shapes.TRI_EPS
constexpr float kAabbEps = 0.001f;    // shapes.AABB_EPS

// The scene and the walk, as every kernel takes them.
struct Walk {
    const float* coeffs;    // (4, t_pad, 10)
    const float* bounds;    // (n_chunks, 8)
    const float* sbounds;   // (n_super, 8); read at g > 1 only
    const int32_t* order;   // (n_tiles, n_super), or null
    const int32_t* count;   // (n_tiles,), or null
    int t_pad, n_chunks, chunk_t, g, n_super;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Load the features of `lane`; false when any of them, or tmax, is NaN.
__device__ __forceinline__ bool load_features(float* p,
                                              const float* __restrict__ phi,
                                              int n, int lane, float tm) {
    bool ok = !isnan(tm);
#pragma unroll
    for (int k = 0; k < 10; ++k) {
        p[k] = __ldg(phi + (size_t)k * n + lane);
        ok = ok && !isnan(p[k]);
    }
    return ok;
}

__device__ __forceinline__ bool chunk_empty(const float* __restrict__ b) {
    return __ldg(b) > __ldg(b + 3);
}

// Slab test of one ray against one box at the bound `upper`.
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

__device__ __forceinline__ float dot10(const float* __restrict__ c,
                                       const float* p) {
    float s = c[0] * p[0];
#pragma unroll
    for (int k = 1; k < 10; ++k) s += c[k] * p[k];
    return s;
}

// Moller scores of triangle j of a staged chunk (4, chunk_t, 10): t, or
// +inf when the triangle is not a valid hit below tmax, as the plain
// version computes it.
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
    return valid ? t : inf_f();
}

// Per-lane state of a closest-hit query: the running (best_t, best_i).
// A lane that is not active (past n, or NaN) keeps the miss.
struct Closest {
    static constexpr bool kStops = false;
    float p[10];
    float tm, bt;
    int bi;
    bool active;

    __device__ void load(const float* __restrict__ phi,
                         const float* __restrict__ tmax, int n) {
        const int lane = blockIdx.x * blockDim.x + threadIdx.x;
        tm = lane < n ? __ldg(tmax + lane) : 0.0f;
        active = lane < n && load_features(p, phi, n, lane, tm);
        bt = inf_f();
        bi = 0;
    }
    __device__ bool wants(const float* __restrict__ b) const {
        return active && slab_may_hit(p, b, fminf(tm, bt));
    }
    __device__ void scan(const float* sh, int chunk_t, int ci) {
        if (!active) return;
        for (int j = 0; j < chunk_t; ++j) {
            const float t = triangle_t(sh, chunk_t, j, p, tm);
            if (t < bt) {
                bt = t;
                bi = ci * chunk_t + j;
            }
        }
    }
};

// Per-lane state of a shadow query: a lane with tmax <= 0 does nothing,
// and a lane leaves the walk at its first hit.
struct AnyHit {
    static constexpr bool kStops = true;
    float p[10];
    float tm;
    bool live, found;

    __device__ void load(const float* __restrict__ phi,
                         const float* __restrict__ tmax, int n) {
        const int lane = blockIdx.x * blockDim.x + threadIdx.x;
        tm = lane < n ? __ldg(tmax + lane) : 0.0f;
        live = lane < n && tm > 0.0f && load_features(p, phi, n, lane, tm);
        found = false;
    }
    __device__ bool wants(const float* __restrict__ b) const {
        return live && !found && slab_may_hit(p, b, tm);
    }
    __device__ bool done() const { return !live || found; }
    __device__ void scan(const float* sh, int chunk_t, int) {
        if (!live || found) return;
        for (int j = 0; j < chunk_t; ++j) {
            if (triangle_t(sh, chunk_t, j, p, tm) < inf_f()) {
                found = true;
                return;
            }
        }
    }
};

// Entries of this block's schedule, and entry r (a superchunk id).
__device__ __forceinline__ int sched_len(const Walk& w) {
    return w.count ? __ldg(w.count + blockIdx.x) : w.n_super;
}

__device__ __forceinline__ const int32_t* sched_row(const Walk& w) {
    return w.order ? w.order + (size_t)blockIdx.x * w.n_super : nullptr;
}

// Block-wide: may any lane of the block hit box b? Also a barrier.
template <class Q>
__device__ __forceinline__ bool block_wants(const Q& q,
                                            const float* __restrict__ b) {
    return __syncthreads_or(q.wants(b)) != 0;
}

// ---------------------------------------------------------------------------
// Resident walk (K1, K3): stage each visited chunk synchronously.

__device__ __forceinline__ void stage_chunk(float* sh, const Walk& w,
                                            int ci) {
    const int per_block = w.chunk_t * 10;
    for (int idx = threadIdx.x; idx < 4 * per_block; idx += blockDim.x) {
        const int blk = idx / per_block;
        const int r = idx - blk * per_block;
        sh[idx] = __ldg(w.coeffs + (size_t)blk * w.t_pad * 10
                        + (size_t)ci * per_block + r);
    }
}

template <class Q>
__device__ __forceinline__ void visit_resident(Q& q, const Walk& w,
                                               float* sh, int ci) {
    const float* b = w.bounds + (size_t)ci * 8;
    if (chunk_empty(b)) return;  // uniform across the block
    // the vote is also the barrier that ends every read of the chunk
    // staged before
    if (!block_wants(q, b)) return;
    stage_chunk(sh, w, ci);
    __syncthreads();
    q.scan(sh, w.chunk_t, ci);
}

template <class Q>
__device__ void walk_resident(Q& q, const Walk& w, float* sh) {
    const int total = sched_len(w);
    const int32_t* ids = sched_row(w);
    for (int r = 0; r < total; ++r) {
        if constexpr (Q::kStops) {
            if (!__syncthreads_or(!q.done())) break;
        }
        const int si = ids ? __ldg(ids + r) : r;
        if (w.g == 1) {
            visit_resident(q, w, sh, si);
            continue;
        }
        if (!block_wants(q, w.sbounds + (size_t)si * 8)) continue;
        const int end = min(si * w.g + w.g, w.n_chunks);
        for (int ci = si * w.g; ci < end; ++ci) visit_resident(q, w, sh, ci);
    }
}

// ---------------------------------------------------------------------------
// Streamed walk (K2, K4): double-buffered cp.async copies of the chunks.

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copy of chunk ci into `slot` as one commit group. Every
// source piece is 16-byte aligned: the launcher checks the base and that
// chunk_t is even, so ci * chunk_t * 40 and t_pad * 40 are multiples of 16.
__device__ __forceinline__ void issue_chunk(float* slot, const Walk& w,
                                            int ci) {
    const int per_block = w.chunk_t * 10;
    const int vecs = per_block / 4;
    for (int idx = threadIdx.x; idx < 4 * vecs; idx += blockDim.x) {
        const int blk = idx / vecs;
        const int r = 4 * (idx - blk * vecs);
        cp_async16(slot + blk * per_block + r,
                   w.coeffs + (size_t)blk * w.t_pad * 10
                   + (size_t)ci * per_block + r);
    }
    cp_async_commit();
}

// Block-wide prefetch gate of chunk ci at the lanes' current bounds.
template <class Q>
__device__ __forceinline__ bool may_visit(const Q& q, const Walk& w, int ci) {
    const float* b = w.bounds + (size_t)ci * 8;
    if (chunk_empty(b)) return false;  // uniform across the block
    return block_wants(q, b);
}

// Scan the run of `len` chunks ids[r] (or base + r when ids is null)
// through the two slots. Returns with no copy in flight.
template <class Q>
__device__ void pipeline(Q& q, const Walk& w, float* slots,
                         const int32_t* ids, int base, int len) {
    const int slot_floats = 4 * w.chunk_t * 10;
    auto chunk = [&](int r) { return ids ? __ldg(ids + r) : base + r; };
    bool started = len > 0 && may_visit(q, w, chunk(0));
    if (started) issue_chunk(slots, w, chunk(0));
    for (int r = 0; r < len; ++r) {
        // The gate's vote comes after the scan of chunk r-1, so it is also
        // the barrier between the last read of slot (r+1)&1 and the copy
        // into it.
        const bool next = r + 1 < len && may_visit(q, w, chunk(r + 1));
        if (next) issue_chunk(slots + ((r + 1) & 1) * slot_floats, w,
                              chunk(r + 1));
        if (started) {
            if (next) {
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();  // every thread's pieces of chunk r landed
            q.scan(slots + (r & 1) * slot_floats, w.chunk_t, chunk(r));
        }
        started = next;
    }
}

template <class Q>
__device__ void walk_streamed(Q& q, const Walk& w, float* slots) {
    const int total = sched_len(w);
    const int32_t* ids = sched_row(w);
    if (w.g == 1) {
        pipeline(q, w, slots, ids, 0, total);
        return;
    }
    for (int r = 0; r < total; ++r) {
        if constexpr (Q::kStops) {
            if (!__syncthreads_or(!q.done())) break;  // no copy in flight
        }
        const int si = ids ? __ldg(ids + r) : r;
        if (!block_wants(q, w.sbounds + (size_t)si * 8)) continue;
        const int base = si * w.g;
        pipeline(q, w, slots, nullptr, base, min(w.g, w.n_chunks - base));
    }
}

// ---------------------------------------------------------------------------
// Kernels. best_t is +inf and best_i 0 on a miss; hit is 0 or 1.

__global__ void __launch_bounds__(kBlock)
closest_hit_kernel(Walk w, const float* __restrict__ phi,
                   const float* __restrict__ tmax, int n,
                   float* __restrict__ best_t, int32_t* __restrict__ best_i) {
    extern __shared__ __align__(16) float sh[];
    Closest q;
    q.load(phi, tmax, n);
    walk_resident(q, w, sh);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < n) {
        best_t[lane] = q.bt;
        best_i[lane] = q.bi;
    }
}

__global__ void __launch_bounds__(kBlock)
closest_hit_streamed_kernel(Walk w, const float* __restrict__ phi,
                            const float* __restrict__ tmax, int n,
                            float* __restrict__ best_t,
                            int32_t* __restrict__ best_i) {
    extern __shared__ __align__(16) float sh[];
    Closest q;
    q.load(phi, tmax, n);
    walk_streamed(q, w, sh);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < n) {
        best_t[lane] = q.bt;
        best_i[lane] = q.bi;
    }
}

__global__ void __launch_bounds__(kBlock)
any_hit_kernel(Walk w, const float* __restrict__ phi,
               const float* __restrict__ tmax, int n,
               uint8_t* __restrict__ hit) {
    extern __shared__ __align__(16) float sh[];
    AnyHit q;
    q.load(phi, tmax, n);
    walk_resident(q, w, sh);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < n) hit[lane] = q.found ? 1 : 0;
}

__global__ void __launch_bounds__(kBlock)
any_hit_streamed_kernel(Walk w, const float* __restrict__ phi,
                        const float* __restrict__ tmax, int n,
                        uint8_t* __restrict__ hit) {
    extern __shared__ __align__(16) float sh[];
    AnyHit q;
    q.load(phi, tmax, n);
    walk_streamed(q, w, sh);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < n) hit[lane] = q.found ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Host side

int make_walk(Walk* w, const float* coeffs, const float* bounds,
              const float* sbounds, const int32_t* order,
              const int32_t* count, int n, int t_pad, int n_chunks,
              int chunk_t, int g, int n_super) {
    if (n <= 0 || n_chunks <= 0 || chunk_t <= 0 || g <= 0
        || t_pad != n_chunks * chunk_t || n_super != (n_chunks + g - 1) / g
        || (g > 1 && sbounds == nullptr)
        || ((order == nullptr) != (count == nullptr)))
        return (int)cudaErrorInvalidValue;
    *w = Walk{coeffs, bounds, sbounds, order, count, t_pad, n_chunks,
              chunk_t, g, n_super};
    return 0;
}

size_t slot_bytes(int chunk_t) {
    return (size_t)4 * chunk_t * 10 * sizeof(float);
}

// Shared memory of one launch; above the default 48 KB the kernel's limit
// is raised first, or the launch would be refused.
int prepare(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int streamed_ok(const float* coeffs, int chunk_t) {
    return ((uintptr_t)coeffs % 16 == 0) && (chunk_t % 2 == 0);
}

}  // namespace

extern "C" {

// Lanes per block: the tile of the chunk schedule.
int kernel_block() { return kBlock; }

// Each entry point launches on `stream` and returns 0 or a cudaError_t
// (cudaGetLastError() after the launch). order/count are both null (walk
// every superchunk in index order) or both set; sbounds is read at g > 1.
int closest_hit_launch(int streamed, const float* coeffs, const float* phi,
                       const float* tmax, const float* bounds,
                       const float* sbounds, const int32_t* order,
                       const int32_t* count, int n, int t_pad, int n_chunks,
                       int chunk_t, int g, int n_super, float* best_t,
                       int32_t* best_i, void* stream) {
    Walk w;
    int err = make_walk(&w, coeffs, bounds, sbounds, order, count, n, t_pad,
                        n_chunks, chunk_t, g, n_super);
    if (err) return err;
    const int grid = (n + kBlock - 1) / kBlock;
    if (streamed) {
        if (!streamed_ok(coeffs, chunk_t)) return (int)cudaErrorMisalignedAddress;
        const size_t smem = 2 * slot_bytes(chunk_t);
        if ((err = prepare((const void*)closest_hit_streamed_kernel, smem)))
            return err;
        closest_hit_streamed_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
            w, phi, tmax, n, best_t, best_i);
    } else {
        const size_t smem = slot_bytes(chunk_t);
        if ((err = prepare((const void*)closest_hit_kernel, smem))) return err;
        closest_hit_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
            w, phi, tmax, n, best_t, best_i);
    }
    return (int)cudaGetLastError();
}

int any_hit_launch(int streamed, const float* coeffs, const float* phi,
                   const float* tmax, const float* bounds,
                   const float* sbounds, const int32_t* order,
                   const int32_t* count, int n, int t_pad, int n_chunks,
                   int chunk_t, int g, int n_super, uint8_t* hit,
                   void* stream) {
    Walk w;
    int err = make_walk(&w, coeffs, bounds, sbounds, order, count, n, t_pad,
                        n_chunks, chunk_t, g, n_super);
    if (err) return err;
    const int grid = (n + kBlock - 1) / kBlock;
    if (streamed) {
        if (!streamed_ok(coeffs, chunk_t)) return (int)cudaErrorMisalignedAddress;
        const size_t smem = 2 * slot_bytes(chunk_t);
        if ((err = prepare((const void*)any_hit_streamed_kernel, smem)))
            return err;
        any_hit_streamed_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
            w, phi, tmax, n, hit);
    } else {
        const size_t smem = slot_bytes(chunk_t);
        if ((err = prepare((const void*)any_hit_kernel, smem))) return err;
        any_hit_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
            w, phi, tmax, n, hit);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
