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
// One thread owns one ray. A block of kBlock = 256 lanes (K1, K3, K4) or
// kStreamedClosestBlock lanes (K2) is the ray tile: it walks its own
// near-to-far schedule, order[blockIdx.x, :count[blockIdx.x]]
// (ops/intersect_kernel.py:tile_chunk_order, built per block), whose
// entries are superchunks of g morton-consecutive chunks (g = 1: single
// chunks). A null schedule walks every superchunk in index order. At g > 1
// the walk is two-level, as in the TPU kernels: the superchunk's union box
// is slab-tested at each lane's current bound and skipped when no lane can
// reach it; then each member chunk is culled the same way. The cull
// follows _chunk_cull: d[k] == 0 always passes that axis, the far plane is
// inflated by 1 + AABB_EPS, inverted boxes are skipped outright. A lane
// with a NaN feature or tmax can hit nothing and takes no part in the
// walk: the TPU kernel's min/max carry the NaN into its slab test, which
// then fails, whereas fminf/fmaxf here would drop it and pass every box.
//
// K1, K3 (resident) stage each chunk they visit synchronously in shared
// memory (4 * chunk_t * 10 f32, 40 KB at chunk_t = 256); K4 keeps two such
// slots (80 KB, dynamic shared memory above the 48 KB default, so the
// launcher raises the kernel's limit first) and copies chunk r+1 with
// cp.async in 16-byte pieces while chunk r is scanned, in the order of the
// TPU kernels: decide block-wide whether chunk r+1 may be hit at the
// current bound, issue its copy if so, then wait for chunk r and scan it
// if its own copy was issued. There is no re-cull at visit time: bounds
// only shrink, so a chunk that passed at prefetch time is scanned, and one
// that failed would fail again. At g > 1 the pipeline restarts for each
// superchunk that passes its union-box test. In these three the cull acts
// only through the block-wide skip, as the TPU kernel's per-tile
// jnp.any(_chunk_cull(...)): a lane whose own test fails still scans a
// chunk its neighbours need.
//
// K2 is redesigned for Hopper, where 32 lanes, not the whole tile, execute
// together (walk_warp):
// - Warp-granular cull. The same votes at the same points decide, per
//   warp (__any_sync over Closest::wants), whether the warp scans the
//   superchunk's members and each chunk; the block-wide OR of the same
//   votes decides the copy, through a two-slot cp.async ring. A warp
//   skips a chunk only when none of its lanes can hit the chunk's box
//   below its current bound, which the scan could not have changed, so
//   every lane's best_t and best_i are those of the block-granular walk.
// - 128-bit shared-memory reads. A chunk is staged triangle-major, the 40
//   coefficients of a triangle (rows a, n.s, m.e2, m.e1) contiguous,
//   filled with 8-byte cp.async.ca pieces read in global-memory order; the
//   scan reads a triangle with 10 ld.shared.v4 (all lanes of a warp on
//   one address, a broadcast), where the row-major stage of K1, K3 and K4
//   takes 20 ld.shared.v2. dot10's order of summation is kept, so t is bit
//   for bit K1's.
// - Occupancy. A block still waits at every staged piece for its slowest
//   warp, so the time a warp with nothing to scan spends waiting is given
//   to other blocks: chunks are staged in pieces of kPieceTris = 32
//   triangles (two 5 KB slots, not two 40 KB chunks), a block has
//   kStreamedClosestBlock = 64 lanes (2 warps), and a thread at most 64
//   registers (kStreamedClosestMinBlocks = 16 blocks, 32 warps per SM,
//   where two 40 KB slots allowed 2 blocks of 8 warps). Measured on
//   cornell-sub6 (PERF.md): 256-lane blocks 22.7 ms, 128 20.1, 64 18.4,
//   32 17.8; 64 keeps the warp vote apart from the block's at 3% cost.
// - Divide only for candidates: a triangle is rejected
//   from rcp.approx.ftz (K5's instruction, max rel error 2^-23.28 on the
//   H100) with a relative slack of 2^-19, first from a and n.s alone
//   (behind the ray or beyond min(tmax, best_t): the other two rows are
//   not read), then from u and v; only a triangle that may be a valid hit
//   takes the exact IEEE divide, so every value kept is the exact path's.
// - Tensor cores are not used: the score product has depth 10 (16 padded)
//   and TF32's 10-bit mantissa would break the exact-f32 contract with the
//   JAX CPU path (best_t within rtol 1e-5), and the cost lies in tests the
//   answer does not need, which wgmma would make cheaper, not fewer.
// - An optional stats pointer counts per launch the chunks copied and the
//   (warp, chunk) scans run; it is null on the main path, where the
//   counting is compiled out.
//
// Per lane and triangle a scan evaluates a, n.s, m.e2, m.e1 as 10-term
// f32 dot products, then the exact IEEE divide of the plain version
// (intersect_kernel.py:_chunk_scores). No fast math: nvcc may contract
// mul+add into FMA, so t differs from the plain version by a few ulps.
// The merge is a strict <, so within one chunk the lowest index wins a
// tie; across chunks an exact-t tie goes to the chunk visited first.
//
// What bounds the kernels on an H100 is not measured (Nsight Compute does
// not run where the card is). A lane reads 44 bytes of features and tmax
// and writes 8; each visited chunk costs the block 40 KB of coefficient
// reads, from L2 for the 14.4 MB of a 90k-triangle scene. Per lane and
// triangle the scan issues 40 FMAs, the divide and the validity tests;
// K1, K3 and K4 read the coefficients with 40 scalar broadcast loads,
// which an SM issues at about a quarter of its FMA rate. The schedule and
// the culls decide how many chunks are scanned at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kStreamedClosestBlock = 64;   // K2's lanes per block
constexpr int kStreamedClosestMinBlocks = 16; // K2's blocks per SM, at least
constexpr int kPieceTris = 32;               // K2 stages chunks in pieces
constexpr int kWarp = 32;
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

// From the four scores of one triangle: t, or +inf when the triangle is
// not a valid hit below tmax, as the plain version computes it.
__device__ __forceinline__ float moller_t(float a, float nt, float nu,
                                          float nv, float tmax) {
    const bool nondeg = fabsf(a) >= kTriEps;
    const float inv_a = (nondeg ? 1.0f : 0.0f) / (nondeg ? a : 1.0f);
    const float t = nt * inv_a;
    const float u = nu * inv_a;
    const float v = -nv * inv_a;
    const bool valid = nondeg && (u >= 0.0f) && (v >= 0.0f)
                       && (u + v <= 1.0f) && (t > 0.0f) && (t < tmax);
    return valid ? t : inf_f();
}

// Triangle j of a chunk staged row-major, (4, chunk_t, 10).
__device__ __forceinline__ float triangle_t(const float* sh, int chunk_t,
                                            int j, const float* p,
                                            float tmax) {
    const int stride = chunk_t * 10;
    return moller_t(dot10(sh + j * 10, p), dot10(sh + stride + j * 10, p),
                    dot10(sh + 2 * stride + j * 10, p),
                    dot10(sh + 3 * stride + j * 10, p), tmax);
}

__device__ __forceinline__ float rcp_approx(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// The rejection of a triangle without the divide, in two stages: True
// only when it cannot be a valid hit below `upper` = min(tmax, best_t).
// t, u, v from rcp.approx.ftz differ from the exact path's by a relative
// 2^-22 at most (the instruction's 2^-23.28, the IEEE quotient's and the
// products' roundings), so a sign test beyond -1e-30 (no product
// underflows there) and the bounds shrunk by 2^-19 never reject a
// triangle the exact path keeps. NaN, overflow and a flushed reciprocal
// fall through to it.
constexpr float kNeg = -1e-30f;
constexpr float kShrink = 1.0f - 0x1p-19f;

// Stage 1, from the determinant and the distance alone; r = rcp(a).
__device__ __forceinline__ bool surely_beyond(float a, float nt, float upper,
                                              float& r) {
    if (!(fabsf(a) >= kTriEps)) return true;
    r = rcp_approx(a);
    const float t = nt * r;
    return t < kNeg || (t < 1e38f && t * kShrink >= upper);
}

// Stage 2, from the barycentrics.
__device__ __forceinline__ bool surely_outside(float r, float nu, float nv) {
    const float u = nu * r;
    const float v = -nv * r;
    return u < kNeg || v < kNeg || (u + v) * kShrink > 1.0f;
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
    // The same over `count` triangles staged triangle-major (count, 40),
    // 16-byte aligned, the first of them triangle `first` of the scene:
    // ten 128-bit loads per triangle.
    __device__ void scan_tri(const float* sh, int count, int first) {
        if (!active) return;
        const float4* s4 = reinterpret_cast<const float4*>(sh);
#pragma unroll 1
        for (int j = 0; j < count; ++j) {
            // rows a and n.s are floats 0-19 of the triangle, n.e2 and n.e1
            // floats 20-39: five float4 each, read as each stage needs them
            float c[40];
            auto stage = [&](int k0) {
#pragma unroll
                for (int k = k0; k < k0 + 5; ++k) {
                    const float4 v = s4[10 * j + k];
                    c[4 * k] = v.x;
                    c[4 * k + 1] = v.y;
                    c[4 * k + 2] = v.z;
                    c[4 * k + 3] = v.w;
                }
            };
            stage(0);
            const float a = dot10(c, p);
            const float nt = dot10(c + 10, p);
            float r;
            if (surely_beyond(a, nt, fminf(tm, bt), r)) continue;
            stage(5);
            const float nu = dot10(c + 20, p);
            const float nv = dot10(c + 30, p);
            if (surely_outside(r, nu, nv)) continue;
            const float t = moller_t(a, nt, nu, nv, tm);
            if (t < bt) {
                bt = t;
                bi = first + j;
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
// Streamed walk with a warp-granular cull (K2): the copy is block-wide, the
// scan per warp; chunks staged triangle-major.

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

// Issue the copy of triangles [first, first + count) of chunk ci into
// `slot` as one commit group, triangle-major: row r's 10 coefficients of
// triangle first + j land at slot[40 j + 10 r]. Consecutive threads read
// consecutive 8-byte pieces of each row block; every piece is 8-byte
// aligned (the launcher checks the base).
__device__ __forceinline__ void issue_piece(float* slot, const Walk& w,
                                            int ci, int first, int count) {
    const int per_row = count * 5;   // 8-byte pieces per row block
    const float* src = w.coeffs + ((size_t)ci * w.chunk_t + first) * 10;
    for (int idx = threadIdx.x; idx < 4 * per_row; idx += blockDim.x) {
        const int row = idx / per_row;
        const int rem = idx - row * per_row;
        const int j = rem / 5;
        const int k = 2 * (rem - 5 * j);
        cp_async8(slot + 40 * j + 10 * row + k,
                  src + (size_t)row * w.t_pad * 10 + 2 * rem);
    }
    cp_async_commit();
}

// Chunks copied (thread 0's count) and (warp, chunk) scans run (lane 0's
// count in each warp); at kOn = false they compile to nothing.
template <bool kOn>
struct WalkCounts {
    unsigned long long copies = 0, scans = 0;
    __device__ void copied() {
        if constexpr (kOn) ++copies;
    }
    __device__ void scanned() {
        if constexpr (kOn) ++scans;
    }
};

// The vote on chunk ci at the lanes' current bounds, also a barrier:
// whether any lane of the block may hit it (it is copied), and in `warp`
// whether any lane of this warp may (the warp scans it). warp_in is false
// when no lane of the warp reached the enclosing superchunk.
template <class Q>
__device__ __forceinline__ bool vote_chunk(const Q& q, const Walk& w, int ci,
                                           bool warp_in, bool& warp) {
    const float* b = w.bounds + (size_t)ci * 8;
    warp = false;
    if (chunk_empty(b)) return false;  // uniform across the block
    const bool mine = warp_in && q.wants(b);
    warp = __any_sync(0xffffffffu, mine);
    return __syncthreads_or(mine) != 0;
}

// pipeline() with the warp-granular scan, each chunk staged in pieces of
// kPieceTris triangles through the two slots (2 x 10 KB at 64), so that
// more blocks share an SM: a block waits at every piece for its slowest
// warp, and other blocks' warps fill that time. The piece after (r, p)
// is copied while (r, p) is scanned; the vote on chunk r+1 comes with the
// last piece of chunk r. Returns with no copy in flight.
template <class Q, class C>
__device__ void pipeline_warp(Q& q, const Walk& w, float* slots,
                              const int32_t* ids, int base, int len,
                              bool warp_in, C& n) {
    const int piece_t = min(w.chunk_t, kPieceTris);
    const int parts = (w.chunk_t + piece_t - 1) / piece_t;
    auto chunk = [&](int r) { return ids ? __ldg(ids + r) : base + r; };
    auto piece = [&](int s) { return slots + s * 40 * piece_t; };
    auto size = [&](int p) { return min(piece_t, w.chunk_t - p * piece_t); };
    int slot = 0;            // where the next piece to scan lies
    bool scan_cur = false;
    bool have = len > 0 && vote_chunk(q, w, chunk(0), warp_in, scan_cur);
    if (have) {
        issue_piece(piece(slot), w, chunk(0), 0, size(0));
        n.copied();
    }
    for (int r = 0; r < len; ++r) {
        const int ci = chunk(r);
        bool have_next = false;
        bool scan_next = false;
        for (int p = 0; p < parts; ++p) {
            bool issued = false;
            if (p + 1 < parts) {
                if (!have) continue;  // uniform across the block
                __syncthreads();      // the reads of slot ^ 1 are done
                issue_piece(piece(slot ^ 1), w, ci, (p + 1) * piece_t,
                            size(p + 1));
                issued = true;
            } else {
                // the vote is also the barrier before the copy
                have_next = r + 1 < len && vote_chunk(q, w, chunk(r + 1),
                                                      warp_in, scan_next);
                if (have_next) {
                    issue_piece(piece(have ? slot ^ 1 : slot), w,
                                chunk(r + 1), 0, size(0));
                    n.copied();
                    issued = true;
                }
            }
            if (!have) continue;
            if (issued) {
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();  // every thread's part of piece (r, p) landed
            if (scan_cur) {
                q.scan_tri(piece(slot), size(p), ci * w.chunk_t + p * piece_t);
                if (p == 0) n.scanned();
            }
            slot ^= 1;
        }
        have = have_next;
        scan_cur = scan_next;
    }
}

template <class Q, class C>
__device__ void walk_warp(Q& q, const Walk& w, float* slots, C& n) {
    const int total = sched_len(w);
    const int32_t* ids = sched_row(w);
    if (w.g == 1) {
        pipeline_warp(q, w, slots, ids, 0, total, true, n);
        return;
    }
    for (int r = 0; r < total; ++r) {
        const int si = ids ? __ldg(ids + r) : r;
        const bool mine = q.wants(w.sbounds + (size_t)si * 8);
        const bool warp_in = __any_sync(0xffffffffu, mine);
        if (!__syncthreads_or(mine)) continue;
        const int base = si * w.g;
        pipeline_warp(q, w, slots, nullptr, base, min(w.g, w.n_chunks - base),
                      warp_in, n);
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

// kStats: stats is (2,) counts to which the launch adds the chunks it
// copied and the (warp, chunk) scans it ran; otherwise it is not read.
template <bool kStats>
__global__ void __launch_bounds__(kStreamedClosestBlock,
                                  kStreamedClosestMinBlocks)
closest_hit_streamed_kernel(Walk w, const float* __restrict__ phi,
                            const float* __restrict__ tmax, int n,
                            float* __restrict__ best_t,
                            int32_t* __restrict__ best_i,
                            unsigned long long* __restrict__ stats) {
    extern __shared__ __align__(16) float sh[];
    Closest q;
    q.load(phi, tmax, n);
    WalkCounts<kStats> counts;
    walk_warp(q, w, sh, counts);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < n) {
        best_t[lane] = q.bt;
        best_i[lane] = q.bi;
    }
    if constexpr (kStats) {
        if (threadIdx.x == 0) atomicAdd(stats, counts.copies);
        if (threadIdx.x % kWarp == 0) atomicAdd(stats + 1, counts.scans);
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

// Lanes per block, the tile of the chunk schedule: of K1, K3 and K4, and
// of K2.
int kernel_block() { return kBlock; }
int streamed_closest_block() { return kStreamedClosestBlock; }

// Each entry point launches on `stream` and returns 0 or a cudaError_t
// (cudaGetLastError() after the launch). order/count are both null (walk
// every superchunk in index order) or both set, built at the variant's
// block; sbounds is read at g > 1. stats (K2 only) is null or (2,) counts.
int closest_hit_launch(int streamed, const float* coeffs, const float* phi,
                       const float* tmax, const float* bounds,
                       const float* sbounds, const int32_t* order,
                       const int32_t* count, int n, int t_pad, int n_chunks,
                       int chunk_t, int g, int n_super, float* best_t,
                       int32_t* best_i, unsigned long long* stats,
                       void* stream) {
    Walk w;
    int err = make_walk(&w, coeffs, bounds, sbounds, order, count, n, t_pad,
                        n_chunks, chunk_t, g, n_super);
    if (err) return err;
    if (streamed) {
        if (!streamed_ok(coeffs, chunk_t)) return (int)cudaErrorMisalignedAddress;
        const int grid = (n + kStreamedClosestBlock - 1) / kStreamedClosestBlock;
        const size_t smem = 2 * slot_bytes(min(chunk_t, kPieceTris));
        auto kernel = stats ? closest_hit_streamed_kernel<true>
                            : closest_hit_streamed_kernel<false>;
        if ((err = prepare((const void*)kernel, smem))) return err;
        kernel<<<grid, kStreamedClosestBlock, smem, (cudaStream_t)stream>>>(
            w, phi, tmax, n, best_t, best_i, stats);
    } else {
        if (stats) return (int)cudaErrorInvalidValue;
        const int grid = (n + kBlock - 1) / kBlock;
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
