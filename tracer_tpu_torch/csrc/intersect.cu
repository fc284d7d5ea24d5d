// Dense ray-triangle intersection kernels for Hopper (sm_90a).
//
// All the kernels test rays against the triangles of a scene built by
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
// all in tracer_tpu/ops/pallas/intersect_kernel.py, and
//   closest_hit_exact_kernel     the yardstick the four are held against:
//                                K1's function by the plainest walk.
//
// One thread owns one ray. A block is the ray tile: kBlock lanes (K1),
// kAnyBlock (K3), kStreamedClosestBlock (K2), kStreamedAnyBlock (K4) or
// kExactBlock (the yardstick). It walks its tile's near-to-far schedule,
// order[tile, :count[tile]] (ops/intersect_kernel.py:tile_chunk_order,
// built per block; tile = blockIdx.x unless the launch orders its blocks),
// whose entries are superchunks of g morton-consecutive chunks (g = 1:
// single chunks). A null schedule walks every superchunk in index order. At g > 1
// the walk is two-level, as in the TPU kernels: the superchunk's union box
// is slab-tested at each lane's current bound and skipped when no lane can
// reach it; then each member chunk is culled the same way. The cull
// follows _chunk_cull: d[k] == 0 always passes that axis, the far plane is
// inflated by 1 + AABB_EPS, inverted boxes are skipped outright. A lane
// with a NaN feature or tmax can hit nothing and takes no part in the
// walk: the TPU kernel's min/max carry the NaN into its slab test, which
// then fails, whereas fminf/fmaxf here would drop it and pass every box.
// Nor does a lane with tmax <= 0 (a dead lane of the path tracer, or a
// shadow lane with no light to test): t < tmax fails for every t > 0, so
// it reads no features and votes no, and a warp or block of such lanes
// copies and scans nothing. The miss is (+inf, 0) either way.
//
// The yardstick (closest_hit_exact_kernel, walk_resident) is the exact path
// in its plainest form: it stages each chunk it visits synchronously and
// row-major in shared memory (4 * chunk_t * 10 f32, 40 KB at chunk_t =
// 256), culls through the block-wide vote alone, as the TPU kernel's
// per-tile jnp.any(_chunk_cull(...)) (a lane whose own test fails still
// scans a chunk its neighbours need), reads a triangle with 20
// ld.shared.v2 and takes the IEEE divide on every (lane, triangle). The
// path tracer never launches it; the smoke run and the card tests hold
// K1 and K2 to its best t bit for bit and K3 and K4 to its hits.
//
// K1, K2, K3 and K4 are designed for Hopper, where 32 lanes, not the whole
// tile, execute together:
// - Warp-granular cull. The same votes at the same points decide, per
//   warp (__any_sync over Q::wants), whether the warp scans the
//   superchunk's members and each chunk; the block-wide OR of the same
//   votes decides the copy. A warp skips a chunk only when none of its
//   lanes can hit the chunk's box below its current bound, which the scan
//   could not have changed, so every lane's result is that of the
//   block-granular walk.
// - 128-bit shared-memory reads. A chunk is staged triangle-major, the 40
//   coefficients of a triangle (rows a, n.s, m.e2, m.e1) contiguous,
//   filled with 8-byte cp.async.ca pieces read in global-memory order; the
//   scan reads a triangle with 10 ld.shared.v4 (all lanes of a warp on
//   one address, a broadcast). dot10's order of summation is kept, so t is
//   bit for bit the yardstick's.
// - Divide only for candidates: a triangle is rejected from
//   rcp.approx.ftz (K5's instruction, max rel error 2^-23.28 on the H100)
//   with a relative slack of 2^-19, first from a and n.s alone (behind
//   the ray or beyond the lane's bound: the other two rows are not read),
//   then from u and v; only a triangle that may be a valid hit takes the
//   exact IEEE divide, so every value kept, and every hit reported, is
//   the exact path's.
// - Tensor cores are not used: the score product has depth 10 (16 padded)
//   and TF32's 10-bit mantissa would break the exact-f32 contract with the
//   JAX CPU path (best_t within rtol 1e-5), and the cost lies in tests the
//   answer does not need, which wgmma would make cheaper, not fewer.
//
// K2 and K4 (streamed, walk_warp) copy through a two-slot cp.async ring
// and give the time a warp with nothing to scan spends at the block's
// barriers to other blocks: chunks are staged in pieces of 32 triangles
// (two 5 KB slots, not two 40 KB chunks) by small blocks of at most 64
// registers a thread, so that 32 warps share an SM. K2: 64 lanes, at least
// 16 blocks per SM (measured on cornell-sub6, PERF.md: 256-lane blocks
// 22.7 ms, 128 20.1, 64 18.4, 32 17.8; 64 keeps the warp vote apart from
// the block's at 3% cost). K4's constants are its own, measured on the
// 524,288 shadow lanes of the same scene (PERF.md: 256-lane blocks 7.84
// ms, 128 7.03, 64 7.00, 32 7.5-7.7, tiles in index order). K4 is a stopping
// query: a dead lane (tmax <= 0) and a lane that found its hit vote no, a
// warp whose lanes are all done skips the rest of its chunk, and a block
// with no lane left starts no further copy and returns once none is in
// flight. An optional stats pointer counts per launch the chunks copied
// and the (warp, chunk) scans run; it is null on the main path, where the
// counting is compiled out.
//
// Every kernel but the yardstick takes an order of its tiles from the
// launcher (block b works tile tiles[b]: the tiles with the longest
// schedules first). Blocks
// start in index order and a tile's walk is as long as its schedule; a
// shadow tile's is 8 entries in the mean and up to 36 on cornell-sub6, so
// in index order the card ends on a few long walks started last (K4 alone
// on that scene's 524,288 shadow lanes, on an H100 at 700 W: 7.01 ms in
// index order, 5.50 ms longest first).
//
// K1 and K3 (resident, walk_resident_warp) keep a whole chunk per barrier
// and no ring: their main path is the one-chunk box, where a ring buys
// nothing. They fill their one slot through the streamed kernels' copy
// (one piece spanning the whole chunk, then a wait) rather than a
// transposing store from registers: the 8-byte pieces land triangle-major
// without passing through registers or conflicting on banks, and the
// routine is the one K2 and K4 already exercise. K1 has no early stop: a
// lane's bound min(tmax, best_t) tightens as it scans, so the first stage
// of the rejection ends most of the tests behind its first hit, and every
// kept t goes through moller_t, the yardstick's own arithmetic.
//
// Per lane and triangle a scan evaluates a, n.s, m.e2, m.e1 as 10-term
// f32 dot products, then the exact IEEE divide of the plain version
// (intersect_kernel.py:_chunk_scores). No fast math: nvcc may contract
// mul+add into FMA, so t differs from the plain version by a few ulps.
// The merge is a strict <, so within one chunk the lowest index wins a
// tie; across chunks an exact-t tie goes to the chunk visited first, which
// depends on the tile's schedule and so on the lanes per block.
//
// What bounds the kernels on an H100 is not measured (Nsight Compute does
// not run where the card is). A lane reads 44 bytes of features and tmax
// and writes 8 (K1, K2) or 1 (K3, K4); each chunk a block copies costs it
// chunk_t * 160 bytes of coefficient reads, from L2 for the 14.4 MB of a
// 90k-triangle scene. Per lane and triangle the full scan runs 40 FMAs,
// the divide and the validity tests, and reads the coefficients with 20
// LDS.64 (the yardstick) or 10 LDS.128 (K1-K4, 5 for a triangle rejected
// at the first stage), as cuobjdump -sass shows them. The schedule and the
// culls decide how many chunks are scanned at all; K1's lanes per block and
// blocks per SM are measured (PERF.md), as K2's, K3's and K4's are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;                   // K1's lanes per block
constexpr int kClosestMinBlocks = 4;          // K1's blocks per SM, at least
constexpr int kExactBlock = 256;              // the yardstick's lanes per block
constexpr int kAnyBlock = 256;                // K3's lanes per block
constexpr int kAnyMinBlocks = 4;              // K3's blocks per SM, at least
constexpr int kStreamedClosestBlock = 64;     // K2's lanes per block
constexpr int kStreamedClosestMinBlocks = 16; // K2's blocks per SM, at least
constexpr int kPieceTris = 32;                // K2 stages chunks in pieces
constexpr int kStreamedAnyBlock = 64;         // K4's lanes per block
constexpr int kStreamedAnyMinBlocks = 16;     // K4's blocks per SM, at least
constexpr int kStreamedAnyPiece = 32;         // K4 stages chunks in pieces
constexpr int kWarp = 32;
constexpr unsigned kFullWarp = 0xffffffffu;
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

// Rows k0 / 5 and k0 / 5 + 1 of triangle j of a stage laid out triangle-
// major (count, 40), 16-byte aligned: five 128-bit loads into c[4 k0 ..].
// Rows a and n.s are floats 0-19 of the triangle (k0 = 0), m.e2 and m.e1
// floats 20-39 (k0 = 5), read as each stage of the rejection needs them.
__device__ __forceinline__ void load_rows(float* c, const float4* s4, int j,
                                          int k0) {
#pragma unroll
    for (int k = k0; k < k0 + 5; ++k) {
        const float4 v = s4[10 * j + k];
        c[4 * k] = v.x;
        c[4 * k + 1] = v.y;
        c[4 * k + 2] = v.z;
        c[4 * k + 3] = v.w;
    }
}

// Per-lane state of a closest-hit query: the running (best_t, best_i).
// A lane that is not active (past n, tmax <= 0, or NaN) keeps the miss.
// The kernel names the lane, which follows the tile its block was given.
struct Closest {
    static constexpr bool kStops = false;
    float p[10];
    float tm, bt;
    int bi;
    bool active;

    __device__ void load(const float* __restrict__ phi,
                         const float* __restrict__ tmax, int n, int lane) {
        tm = lane < n ? __ldg(tmax + lane) : 0.0f;
        active = lane < n && tm > 0.0f && load_features(p, phi, n, lane, tm);
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
            float c[40];
            load_rows(c, s4, j, 0);
            const float a = dot10(c, p);
            const float nt = dot10(c + 10, p);
            float r;
            if (surely_beyond(a, nt, fminf(tm, bt), r)) continue;
            load_rows(c, s4, j, 5);
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
// and a lane leaves the walk at its first hit. The kernel names the lane,
// which follows the tile its block was given.
struct AnyHit {
    static constexpr bool kStops = true;
    float p[10];
    float tm;
    bool live, found;

    __device__ void load(const float* __restrict__ phi,
                         const float* __restrict__ tmax, int n, int lane) {
        tm = lane < n ? __ldg(tmax + lane) : 0.0f;
        live = lane < n && tm > 0.0f && load_features(p, phi, n, lane, tm);
        found = false;
    }
    __device__ bool done() const { return !live || found; }
    __device__ bool wants(const float* __restrict__ b) const {
        return !done() && slab_may_hit(p, b, tm);
    }
    // Closest::scan_tri for a shadow lane: the bound of the first stage is
    // the lane's tmax, and the first triangle the exact path confirms ends
    // the lane's walk.
    __device__ void scan_tri(const float* sh, int count, int) {
        if (done()) return;
        const float4* s4 = reinterpret_cast<const float4*>(sh);
#pragma unroll 1
        for (int j = 0; j < count; ++j) {
            float c[40];
            load_rows(c, s4, j, 0);
            const float a = dot10(c, p);
            const float nt = dot10(c + 10, p);
            float r;
            if (surely_beyond(a, nt, tm, r)) continue;
            load_rows(c, s4, j, 5);
            const float nu = dot10(c + 20, p);
            const float nv = dot10(c + 30, p);
            if (surely_outside(r, nu, nv)) continue;
            if (moller_t(a, nt, nu, nv, tm) < inf_f()) {
                found = true;
                return;
            }
        }
    }
};

// The tile of lanes a block works and whose schedule it walks: its own
// index, or tiles[blockIdx.x] where the launch orders its blocks (the
// tiles with the longest schedules first, so that the card does not end on
// a few long walks started last).
__device__ __forceinline__ unsigned block_tile(
        const int32_t* __restrict__ tiles) {
    return tiles ? (unsigned)__ldg(tiles + blockIdx.x) : blockIdx.x;
}

// Entries of a tile's schedule, and its row of entries (superchunk ids).
__device__ __forceinline__ int sched_len(const Walk& w, unsigned tile) {
    return w.count ? __ldg(w.count + tile) : w.n_super;
}

__device__ __forceinline__ const int32_t* sched_row(const Walk& w,
                                                    unsigned tile) {
    return w.order ? w.order + (size_t)tile * w.n_super : nullptr;
}

// Block-wide: may any lane of the block hit box b? Also a barrier.
template <class Q>
__device__ __forceinline__ bool block_wants(const Q& q,
                                            const float* __restrict__ b) {
    return __syncthreads_or(q.wants(b)) != 0;
}

// ---------------------------------------------------------------------------
// The yardstick's walk: stage each visited chunk synchronously, row-major;
// the cull acts through the block-wide vote alone.

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
    const int total = sched_len(w, blockIdx.x);
    const int32_t* ids = sched_row(w, blockIdx.x);
    for (int r = 0; r < total; ++r) {
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
// Walks with a warp-granular cull (K1-K4): the copy is block-wide, the scan
// per warp; chunks staged triangle-major by cp.async.

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

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
    // stats (2,): the launch's copies and scans, summed over its blocks
    __device__ void add_to(unsigned long long* stats) const {
        if constexpr (kOn) {
            if (threadIdx.x == 0) atomicAdd(stats, copies);
            if (threadIdx.x % kWarp == 0) atomicAdd(stats + 1, scans);
        }
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
    warp = __any_sync(kFullWarp, mine);
    return __syncthreads_or(mine) != 0;
}

// A barrier; for a stopping query also whether any lane of the block is
// still in the walk.
template <class Q>
__device__ __forceinline__ bool lanes_left(const Q& q) {
    if constexpr (Q::kStops) {
        return __syncthreads_or(!q.done()) != 0;
    } else {
        __syncthreads();
        return true;
    }
}

// Scan the run of `len` chunks ids[r] (or base + r when ids is null), each
// staged in pieces of kPiece triangles through the two slots (2 x 5 KB at
// 32), so that more blocks share an SM: a block waits at every piece for
// its slowest warp, and other blocks' warps fill that time. The piece
// after (r, p) is copied while (r, p) is scanned; the vote on chunk r+1
// comes with the last piece of chunk r. There is no re-cull at scan time:
// bounds only shrink, so a chunk that passed its vote is scanned by the
// warps that wanted it, and one that failed would fail again. A stopping
// query ends the run at the first barrier that finds no lane left.
// Returns with no copy in flight.
template <int kPiece, class Q, class C>
__device__ void pipeline_warp(Q& q, const Walk& w, float* slots,
                              const int32_t* ids, int base, int len,
                              bool warp_in, C& n) {
    const int piece_t = min(w.chunk_t, kPiece);
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
                // the barrier after which the reads of slot ^ 1 are done
                if (!lanes_left(q)) {
                    cp_async_wait<0>();  // piece (r, p), which nobody reads
                    return;
                }
                issue_piece(piece(slot ^ 1), w, ci, (p + 1) * piece_t,
                            size(p + 1));
                issued = true;
            } else if (r + 1 < len) {
                // the vote is also the barrier before the copy
                have_next = vote_chunk(q, w, chunk(r + 1), warp_in,
                                       scan_next);
                if (have_next) {
                    issue_piece(piece(have ? slot ^ 1 : slot), w,
                                chunk(r + 1), 0, size(0));
                    n.copied();
                    issued = true;
                } else if (Q::kStops && w.g == 1 && !lanes_left(q)) {
                    // nobody wants it because nobody is left (at g > 1
                    // the walk asks before each superchunk)
                    len = r + 1;
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
                // a warp whose lanes are all done skips the chunk's rest
                if constexpr (Q::kStops) {
                    scan_cur = __any_sync(kFullWarp, !q.done());
                }
            }
            slot ^= 1;
        }
        have = have_next;
        scan_cur = scan_next;
    }
}

// The vote on superchunk si, also a barrier: whether any lane of the
// block may hit its union box, and in `warp` whether any lane of this warp
// may.
template <class Q>
__device__ __forceinline__ bool vote_super(const Q& q, const Walk& w, int si,
                                           bool& warp) {
    const bool mine = q.wants(w.sbounds + (size_t)si * 8);
    warp = __any_sync(kFullWarp, mine);
    return __syncthreads_or(mine) != 0;
}

// Streamed (K2, K4): the chunks go through the two-slot ring; at g > 1 the
// pipeline restarts for each superchunk that passes its vote.
template <int kPiece, class Q, class C>
__device__ void walk_warp(Q& q, const Walk& w, unsigned tile, float* slots,
                          C& n) {
    const int total = sched_len(w, tile);
    const int32_t* ids = sched_row(w, tile);
    if (w.g == 1) {
        pipeline_warp<kPiece>(q, w, slots, ids, 0, total, true, n);
        return;
    }
    for (int r = 0; r < total; ++r) {
        if constexpr (Q::kStops) {
            if (!lanes_left(q)) break;  // no copy in flight
        }
        const int si = ids ? __ldg(ids + r) : r;
        bool warp_in;
        if (!vote_super(q, w, si, warp_in)) continue;
        const int base = si * w.g;
        pipeline_warp<kPiece>(q, w, slots, nullptr, base,
                              min(w.g, w.n_chunks - base), warp_in, n);
    }
}

// Resident (K1, K3): one slot holds the whole chunk, copied and waited for
// between two barriers; a warp scans it when one of its lanes wants it.
template <class Q>
__device__ void walk_resident_warp(Q& q, const Walk& w, unsigned tile,
                                   float* sh) {
    const int total = sched_len(w, tile);
    const int32_t* ids = sched_row(w, tile);
    for (int r = 0; r < total; ++r) {
        if constexpr (Q::kStops) {
            if (!lanes_left(q)) break;
        }
        const int si = ids ? __ldg(ids + r) : r;
        bool warp_in = true;
        if (w.g > 1 && !vote_super(q, w, si, warp_in)) continue;
        const int end = min(si * w.g + w.g, w.n_chunks);
        for (int ci = si * w.g; ci < end; ++ci) {
            // the vote is also the barrier that ends every read of the
            // chunk staged before
            bool scan;
            if (!vote_chunk(q, w, ci, warp_in, scan)) continue;
            issue_piece(sh, w, ci, 0, w.chunk_t);
            cp_async_wait<0>();
            __syncthreads();  // every thread's part of the chunk landed
            if (scan) q.scan_tri(sh, w.chunk_t, ci * w.chunk_t);
        }
    }
}

// ---------------------------------------------------------------------------
// Kernels. best_t is +inf and best_i 0 on a miss; hit is 0 or 1.

__global__ void __launch_bounds__(kBlock, kClosestMinBlocks)
closest_hit_kernel(Walk w, const int32_t* __restrict__ tiles,
                   const float* __restrict__ phi,
                   const float* __restrict__ tmax, int n,
                   float* __restrict__ best_t, int32_t* __restrict__ best_i) {
    extern __shared__ __align__(16) float sh[];
    const unsigned tile = block_tile(tiles);
    const int lane = tile * blockDim.x + threadIdx.x;
    Closest q;
    q.load(phi, tmax, n, lane);
    walk_resident_warp(q, w, tile, sh);
    if (lane < n) {
        best_t[lane] = q.bt;
        best_i[lane] = q.bi;
    }
}

// The yardstick: block-wide cull, row-major stage, the divide on every
// (lane, triangle); tiles in index order.
__global__ void __launch_bounds__(kExactBlock)
closest_hit_exact_kernel(Walk w, const float* __restrict__ phi,
                         const float* __restrict__ tmax, int n,
                         float* __restrict__ best_t,
                         int32_t* __restrict__ best_i) {
    extern __shared__ __align__(16) float sh[];
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    Closest q;
    q.load(phi, tmax, n, lane);
    walk_resident(q, w, sh);
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
closest_hit_streamed_kernel(Walk w, const int32_t* __restrict__ tiles,
                            const float* __restrict__ phi,
                            const float* __restrict__ tmax, int n,
                            float* __restrict__ best_t,
                            int32_t* __restrict__ best_i,
                            unsigned long long* __restrict__ stats) {
    extern __shared__ __align__(16) float sh[];
    const unsigned tile = block_tile(tiles);
    const int lane = tile * blockDim.x + threadIdx.x;
    Closest q;
    q.load(phi, tmax, n, lane);
    WalkCounts<kStats> counts;
    walk_warp<kPieceTris>(q, w, tile, sh, counts);
    if (lane < n) {
        best_t[lane] = q.bt;
        best_i[lane] = q.bi;
    }
    counts.add_to(stats);
}

__global__ void __launch_bounds__(kAnyBlock, kAnyMinBlocks)
any_hit_kernel(Walk w, const int32_t* __restrict__ tiles,
               const float* __restrict__ phi,
               const float* __restrict__ tmax, int n,
               uint8_t* __restrict__ hit) {
    extern __shared__ __align__(16) float sh[];
    const unsigned tile = block_tile(tiles);
    const int lane = tile * blockDim.x + threadIdx.x;
    AnyHit q;
    q.load(phi, tmax, n, lane);
    walk_resident_warp(q, w, tile, sh);
    if (lane < n) hit[lane] = q.found ? 1 : 0;
}

template <bool kStats>
__global__ void __launch_bounds__(kStreamedAnyBlock, kStreamedAnyMinBlocks)
any_hit_streamed_kernel(Walk w, const int32_t* __restrict__ tiles,
                        const float* __restrict__ phi,
                        const float* __restrict__ tmax, int n,
                        uint8_t* __restrict__ hit,
                        unsigned long long* __restrict__ stats) {
    extern __shared__ __align__(16) float sh[];
    const unsigned tile = block_tile(tiles);
    const int lane = tile * blockDim.x + threadIdx.x;
    AnyHit q;
    q.load(phi, tmax, n, lane);
    WalkCounts<kStats> counts;
    walk_warp<kStreamedAnyPiece>(q, w, tile, sh, counts);
    if (lane < n) hit[lane] = q.found ? 1 : 0;
    counts.add_to(stats);
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

// Shared memory of one staged slot. No launch takes more than the 48 KB a
// block gets without an opt-in: the resident kernels stage one chunk (the
// wrapper caps chunk_t; a larger one is refused at the launch), the
// streamed ones two pieces.
size_t slot_bytes(int tris) {
    return (size_t)4 * tris * 10 * sizeof(float);
}

// issue_piece copies 8-byte pieces, each at an even count of floats from
// the base.
bool stage_ok(const float* coeffs) { return (uintptr_t)coeffs % 8 == 0; }

}  // namespace

extern "C" {

// Lanes per block, the tile of the chunk schedule, of K1, K2, K3, K4 and
// the yardstick.
int kernel_block() { return kBlock; }
int exact_block() { return kExactBlock; }
// K1's blocks per SM, at least (its __launch_bounds__ minimum).
int closest_min_blocks() { return kClosestMinBlocks; }
int streamed_closest_block() { return kStreamedClosestBlock; }
int any_block() { return kAnyBlock; }
int streamed_any_block() { return kStreamedAnyBlock; }

// Each entry point launches on `stream` and returns 0 or a cudaError_t
// (cudaGetLastError() after the launch). order/count are both null (walk
// every superchunk in index order) or both set, built at the variant's
// block; sbounds is read at g > 1. stats (K2 and K4 only) is null or (2,)
// counts. tiles is null or a permutation of the tiles, (grid,): block b
// works tile tiles[b]; the yardstick takes none.
int closest_hit_launch(int streamed, const float* coeffs, const float* phi,
                       const float* tmax, const float* bounds,
                       const float* sbounds, const int32_t* order,
                       const int32_t* count, int n, int t_pad, int n_chunks,
                       int chunk_t, int g, int n_super, const int32_t* tiles,
                       float* best_t, int32_t* best_i,
                       unsigned long long* stats, void* stream) {
    Walk w;
    int err = make_walk(&w, coeffs, bounds, sbounds, order, count, n, t_pad,
                        n_chunks, chunk_t, g, n_super);
    if (err) return err;
    if (!stage_ok(coeffs)) return (int)cudaErrorMisalignedAddress;
    if (streamed) {
        const int grid = (n + kStreamedClosestBlock - 1) / kStreamedClosestBlock;
        const size_t smem = 2 * slot_bytes(min(chunk_t, kPieceTris));
        auto kernel = stats ? closest_hit_streamed_kernel<true>
                            : closest_hit_streamed_kernel<false>;
        kernel<<<grid, kStreamedClosestBlock, smem, (cudaStream_t)stream>>>(
            w, tiles, phi, tmax, n, best_t, best_i, stats);
    } else {
        if (stats) return (int)cudaErrorInvalidValue;
        const int grid = (n + kBlock - 1) / kBlock;
        closest_hit_kernel<<<grid, kBlock, slot_bytes(chunk_t),
                             (cudaStream_t)stream>>>(
            w, tiles, phi, tmax, n, best_t, best_i);
    }
    return (int)cudaGetLastError();
}

// The yardstick, resident only; the arguments of closest_hit_launch, of
// which streamed must be 0 and tiles and stats null.
int closest_hit_exact_launch(int streamed, const float* coeffs,
                             const float* phi, const float* tmax,
                             const float* bounds, const float* sbounds,
                             const int32_t* order, const int32_t* count,
                             int n, int t_pad, int n_chunks, int chunk_t,
                             int g, int n_super, const int32_t* tiles,
                             float* best_t, int32_t* best_i,
                             unsigned long long* stats, void* stream) {
    Walk w;
    int err = make_walk(&w, coeffs, bounds, sbounds, order, count, n, t_pad,
                        n_chunks, chunk_t, g, n_super);
    if (err) return err;
    if (streamed || tiles || stats) return (int)cudaErrorInvalidValue;
    const int grid = (n + kExactBlock - 1) / kExactBlock;
    closest_hit_exact_kernel<<<grid, kExactBlock, slot_bytes(chunk_t),
                               (cudaStream_t)stream>>>(
        w, phi, tmax, n, best_t, best_i);
    return (int)cudaGetLastError();
}

int any_hit_launch(int streamed, const float* coeffs, const float* phi,
                   const float* tmax, const float* bounds,
                   const float* sbounds, const int32_t* order,
                   const int32_t* count, int n, int t_pad, int n_chunks,
                   int chunk_t, int g, int n_super, const int32_t* tiles,
                   uint8_t* hit, unsigned long long* stats, void* stream) {
    Walk w;
    int err = make_walk(&w, coeffs, bounds, sbounds, order, count, n, t_pad,
                        n_chunks, chunk_t, g, n_super);
    if (err) return err;
    if (!stage_ok(coeffs)) return (int)cudaErrorMisalignedAddress;
    if (streamed) {
        const int grid = (n + kStreamedAnyBlock - 1) / kStreamedAnyBlock;
        const size_t smem = 2 * slot_bytes(min(chunk_t, kStreamedAnyPiece));
        auto kernel = stats ? any_hit_streamed_kernel<true>
                            : any_hit_streamed_kernel<false>;
        kernel<<<grid, kStreamedAnyBlock, smem, (cudaStream_t)stream>>>(
            w, tiles, phi, tmax, n, hit, stats);
    } else {
        if (stats) return (int)cudaErrorInvalidValue;
        const int grid = (n + kAnyBlock - 1) / kAnyBlock;
        any_hit_kernel<<<grid, kAnyBlock, slot_bytes(chunk_t),
                         (cudaStream_t)stream>>>(w, tiles, phi, tmax, n,
                                                 hit);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
