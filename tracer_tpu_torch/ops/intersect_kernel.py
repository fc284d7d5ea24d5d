"""Wrappers of the hand-written intersection kernels (csrc/intersect.cu),
their plain PyTorch versions, and the chunk schedule the kernels walk.

  closest_hit(coeffs, phi, tmax, chunk_bounds) -> (best_t, best_i)
      replaces tracer_tpu/ops/pallas/intersect_kernel.py:closest_hit_pallas
  any_hit(coeffs, phi, tmax, chunk_bounds) -> hit
      replaces tracer_tpu/ops/pallas/intersect_kernel.py:any_hit_pallas

coeffs (4, T_pad, 10) f32 and chunk_bounds (n_chunks, 8) f32 come from
intersect.build_dense; phi (10, N) f32 is intersect.ray_features_t; tmax
is a scalar or (N,). best_t is +inf and best_i 0 on a miss, best_i in
storage order.

Each wrapper has two variants, as the TPU package has: resident (K1, K3:
each visited chunk staged whole in one shared-memory slot) and streamed
(K2, K4: two slots of 32-triangle pieces, the next piece copied while
the current one is scanned). All four cull per warp, stage a chunk
triangle-major, read a triangle's coefficients with 128-bit loads and
take the divide only for a triangle that may be a valid hit. stream=None
takes the streamed variant when T_pad > STREAM_MIN_T_PAD. All walk the
same kind of per-tile schedule: superchunks of g = ceil(n_chunks /
max_sched) morton-consecutive chunks (superchunk_bounds), in the
near-to-far order of tile_chunk_order, built per CUDA block of the
variant's lanes (BLOCKS). A one-chunk scene gets no schedule and the
kernel walks its chunk under the cull. The schedule only skips chunks no
lane can reach, so every variant gives the plain version's hits and best
t (ties in t may pick another index). All four work their tiles in the
order of heavy_first, the longest schedules first. On the card the
schedule, its superchunk boxes and the tile order are kernels of
csrc/prep.cu (walk_operands), bit for bit these plain versions. A lane
with tmax <= 0 or a NaN operand takes no part in a walk and misses,
(+inf, 0) or False, as the plain versions give it (t < tmax fails).

  closest_hit_exact(coeffs, phi, tmax, chunk_bounds) -> (best_t, best_i)
      the yardstick (closest_hit_exact_kernel): closest_hit by the plainest
      walk, block-granular and row-major, with the IEEE divide on every
      (lane, triangle), resident only, tiles in index order. The smoke run,
      utils/kernel_timing.py and the card tests hold K1 and K2 to its best
      t bit for bit and K3 and K4 to its hits; the path tracer never calls
      it.

Dispatch: closest_hit and any_hit call the torch.library custom ops
tracer_tpu_torch::closest_hit and tracer_tpu_torch::any_hit, whose CPU
implementation is the plain version (closest_hit_ref, any_hit_ref, the
chunked exact-f32 form of tracer_tpu/ops/intersect.py) and whose CUDA
implementation launches the kernel or raises. Eager calls and a program
captured by torch.export (utils/aot.py) run the same implementations;
the ops' fake rules give torch.export the output shapes. A call with
`stats` launches directly, outside the op. The kernels are built with
nvcc at first use by ops/cuda_lib.py, with every other source under
csrc/, and launched and counted there (cuda_lib.launch).
"""

from __future__ import annotations

import torch

from tracer_tpu_torch.ops import cuda_lib, shapes
from tracer_tpu_torch.utils import profiling

# Lanes per CUDA block, the tile of the chunk schedule, of K1, K2, K3, K4
# and the yardstick (csrc/intersect.cu kBlock, kStreamedClosestBlock,
# kAnyBlock, kStreamedAnyBlock and kExactBlock, checked at load).
BLOCK = 256
STREAMED_CLOSEST_BLOCK = 64
ANY_BLOCK = 256
STREAMED_ANY_BLOCK = 64
EXACT_BLOCK = 256
# Most schedule entries per tile (tracer_tpu's MAX_SCHED; csrc/prep.cu
# kMaxSched, checked at load): chunks group into superchunks of g =
# ceil(n_chunks / max_sched).
MAX_SCHED = 64
cuda_lib.expect(kernel_block=BLOCK,
                streamed_closest_block=STREAMED_CLOSEST_BLOCK,
                any_block=ANY_BLOCK, streamed_any_block=STREAMED_ANY_BLOCK,
                exact_block=EXACT_BLOCK, prep_max_sched=MAX_SCHED)
# stream=None streams the coefficients above this many padded triangles:
# where the card's times cross. On an NVIDIA H100 80GB HBM3 at 700 W, on
# the same 262,144 first-bounce rays (utils/kernel_timing.stream_pairs), K1
# / K2 alone take 3.78 / 3.93 ms at 5,632 padded triangles, 9.90 / 8.93 at
# 22,528 and 20.75 / 15.97 at 90,112. Results do not depend on it.
STREAM_MIN_T_PAD = 8_192
# Shared memory per triangle of a staged chunk: 4 rows of 10 f32.
_TRI_BYTES = 4 * 10 * 4
# Largest chunk each variant takes: the resident kernels stage one chunk
# in the 48 KB a block gets without an opt-in; the streamed kernels stage
# 32-triangle pieces of a chunk of any size (None: no cap).
MAX_CHUNK_T = {"resident": (48 * 1024) // _TRI_BYTES, "streamed": None}
# Bound on the (chunks, lanes) f32 temporaries of one schedule batch.
_SCHED_ELEMS = 1 << 24

# The kernels' names in cuda_lib's counts: VARIANTS are the kernels of
# the path (K1-K4), EXACT the yardstick, PREP_KERNELS those of a sorted
# query's preparation (csrc/prep.cu): the key, the deal and gather
# (ops/intersect.py, the ops lane_key and lane_deal), the superchunk boxes,
# the schedule and the tile order (walk_operands). Each launch of K1-K4 and
# the yardstick, and each plain call of the ops, also adds its lanes
# (phi's N, from the shape) to the recorder's counter
# query.lanes.<kernel> (utils/profiling).
VARIANTS = ("closest_hit", "closest_hit_streamed", "any_hit",
            "any_hit_streamed")
EXACT = "closest_hit_exact"
KERNELS = VARIANTS + (EXACT,)
BLOCKS = dict(zip(KERNELS, (BLOCK, STREAMED_CLOSEST_BLOCK, ANY_BLOCK,
                           STREAMED_ANY_BLOCK, EXACT_BLOCK)))
PREP_KERNELS = ("lane_key", "lane_deal", "superchunk", "schedule",
                "heavy_first")


# ---------------------------------------------------------------------------
# Argument checks

def _lane_tmax(tmax, phi):
    """tmax, a scalar or per lane, as f32 on phi's device, a scalar
    expanded to phi's N lanes."""
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    return tmax.expand(phi.shape[-1]) if tmax.dim() == 0 else tmax


def _check(coeffs, phi, tmax, chunk_bounds):
    """Validate the operands; returns (tmax as (N,) f32, n_chunks,
    chunk_t)."""
    if phi.dim() != 2 or phi.shape[0] != 10:
        raise ValueError(f"phi must be (10, N), got {tuple(phi.shape)}")
    n = phi.shape[1]
    if coeffs.dim() != 3 or coeffs.shape[0] != 4 or coeffs.shape[2] != 10:
        raise ValueError(f"coeffs must be (4, T_pad, 10), got "
                         f"{tuple(coeffs.shape)}")
    if chunk_bounds.dim() != 2 or chunk_bounds.shape[1] != 8:
        raise ValueError(f"chunk_bounds must be (n_chunks, 8), got "
                         f"{tuple(chunk_bounds.shape)}")
    n_chunks = chunk_bounds.shape[0]
    t_pad = coeffs.shape[1]
    if n_chunks == 0 or t_pad % n_chunks:
        raise ValueError(f"{t_pad} padded triangles do not split into "
                         f"{n_chunks} chunks")
    for name, x in (("coeffs", coeffs), ("phi", phi),
                    ("chunk_bounds", chunk_bounds)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != phi.device:
            raise ValueError(f"{name} is on {x.device}, phi on {phi.device}")
    tmax = _lane_tmax(tmax, phi)
    if tmax.shape != (n,):
        raise ValueError(f"tmax must be a scalar or ({n},), got "
                         f"{tuple(tmax.shape)}")
    return tmax, n_chunks, t_pad // n_chunks


def _check_options(stream, max_sched) -> None:
    """stream is None, True or False; max_sched an int in 1..MAX_SCHED.
    The wrappers check them before the ops, whose schema would take
    stream=1 as True."""
    if stream is not None and not isinstance(stream, bool):
        raise ValueError(f"stream must be None, True or False, got {stream!r}")
    if (isinstance(max_sched, bool) or not isinstance(max_sched, int)
            or not 1 <= max_sched <= MAX_SCHED):
        raise ValueError(f"max_sched must be an int in 1..{MAX_SCHED}, got "
                         f"{max_sched!r}")


def streamed_variant(t_pad: int, stream=None, max_sched: int = MAX_SCHED
                     ) -> bool:
    """Check the walk options and resolve `stream`: True or False as
    given, None for streaming above STREAM_MIN_T_PAD padded triangles.
    max_sched (1..MAX_SCHED) bounds the schedule entries per tile."""
    _check_options(stream, max_sched)
    return t_pad > STREAM_MIN_T_PAD if stream is None else stream


def _cuda_operands(name, coeffs, phi, tmax, chunk_bounds, chunk_t: int):
    """What kernel `name` takes of the operands _check passed: coeffs,
    phi, tmax (made contiguous) and chunk_bounds, each contiguous on phi's
    device; a resident kernel stages a chunk in 48 KB, K1-K4 copy 8-byte
    pieces of coeffs, lane ids are int32."""
    kind = "streamed" if name.endswith("_streamed") else "resident"
    cap = MAX_CHUNK_T[kind]
    if cap is not None and chunk_t > cap:
        raise ValueError(f"chunk of {chunk_t} triangles exceeds the {kind} "
                         f"kernel's {cap}")
    ops = [cuda_lib.operand(x, phi.device)
           for x in (coeffs, phi, tmax.contiguous(), chunk_bounds)]
    if name != EXACT and coeffs.data_ptr() % 8:
        raise ValueError(f"{name}_kernel stages 8-byte pieces: coeffs must "
                         f"be 8-byte aligned")
    if phi.shape[1] >= 2 ** 31:
        raise ValueError("too many rays for int32 lane ids")
    return ops


# ---------------------------------------------------------------------------
# The schedule (plain torch on either device; XLA-side in the TPU package)

def _empty_boxes(k: int, device):
    """k inverted +inf/-inf boxes, which min/max absorb."""
    inf = float("inf")
    return torch.cat([torch.full((k, 3), inf, device=device),
                      torch.full((k, 3), -inf, device=device),
                      torch.zeros((k, 2), device=device)], dim=1)


def superchunk_bounds(chunk_bounds, g: int):
    """Group g morton-consecutive chunks into one superchunk: (n_chunks, 8)
    -> (ceil(n_chunks / g), 8) union boxes; the last group's padding
    members are empty boxes (tracer_tpu's _superchunk_bounds)."""
    n_chunks = chunk_bounds.shape[0]
    n_super = -(-n_chunks // g)
    pad = n_super * g - n_chunks
    if pad:
        chunk_bounds = torch.cat(
            [chunk_bounds, _empty_boxes(pad, chunk_bounds.device)])
    grp = chunk_bounds.reshape(n_super, g, 8)
    return torch.cat([grp[:, :, 0:3].amin(dim=1), grp[:, :, 3:6].amax(dim=1),
                      torch.zeros((n_super, 2), device=chunk_bounds.device)],
                     dim=1)


def _tile_entry(phi, tmax, boxes, n_tiles: int, tile_n: int):
    """Each tile's nearest slab entry into each box at the rays' tmax,
    +inf where no lane reaches it: boxes (B, 8) -> (B, n_tiles)."""
    tmin = torch.zeros((boxes.shape[0], phi.shape[1]), device=phi.device)
    tmx = tmax.expand(tmin.shape)
    for k in range(3):
        # d[k] == 0 always passes axis k: an origin on a bound plane
        # would give 0 * inf = NaN and drop a box the kernel may need
        par = (phi[k] == 0.0)[None]
        inv = 1.0 / torch.where(par, 1.0, phi[k][None])
        t0 = (boxes[:, k, None] - phi[3 + k][None]) * inv
        t1 = (boxes[:, 3 + k, None] - phi[3 + k][None]) * inv
        tmin = torch.maximum(tmin, torch.where(par, 0.0,
                                               torch.minimum(t0, t1)))
        tmx = torch.minimum(tmx, torch.where(
            par, tmax[None], torch.maximum(t0, t1) * (1.0 + shapes.AABB_EPS)))
    # an inverted (empty) box passes the slab test on every axis
    empty = (boxes[:, 0] > boxes[:, 3])[:, None]
    entry = torch.where((tmx > tmin) & ~empty, tmin, float("inf"))
    return entry.reshape(boxes.shape[0], n_tiles, tile_n).amin(dim=2)


def tile_chunk_order(phi, tmax, bounds, tile_n: int = BLOCK):
    """Per-tile near-to-far visiting order of the boxes `bounds` (K, 8)
    (chunks, or superchunks at g > 1), tracer_tpu's _tile_chunk_order.

    Lanes split into tiles of tile_n; the last tile is padded with lanes
    of phi = 0 and tmax = 0, which reach nothing. For every (tile, box)
    the tile's nearest slab entry at the rays' tmax; boxes no lane reaches
    key +inf. Returns order (n_tiles, K) int32, the box ids sorted by that
    key with a stable sort, and count (n_tiles,) int32, how many boxes any
    lane of the tile reaches. Any superset of the reachable boxes gives
    the same hits and best t, so the order only decides how soon the
    per-lane bounds tighten (and which chunk wins an exact-t tie)."""
    n = phi.shape[1]
    n_pad = -(-n // tile_n) * tile_n
    n_tiles = n_pad // tile_n
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    tmax = torch.nn.functional.pad(tmax.expand(n), (0, n_pad - n))
    phi = torch.nn.functional.pad(phi[:6], (0, n_pad - n))
    k = bounds.shape[0]
    b = max(1, min(k, _SCHED_ELEMS // max(n_pad, 1)))
    keys = torch.cat([_tile_entry(phi, tmax, bounds[i:i + b], n_tiles, tile_n)
                      for i in range(0, k, b)]).T.contiguous()
    order = torch.argsort(keys, dim=1, stable=True).to(torch.int32)
    count = torch.isfinite(keys).sum(dim=1, dtype=torch.int32)
    return order.contiguous(), count


def walk_schedule(phi, tmax, chunk_bounds, max_sched: int = MAX_SCHED,
                  tile_n: int = BLOCK):
    """What a kernel walks: (g, superchunk bounds, order, count), the
    schedule per block of tile_n lanes. At g = 1 the superchunks are the
    chunks; a one-chunk scene gets no schedule (order and count None)."""
    n_chunks = chunk_bounds.shape[0]
    g = -(-n_chunks // max_sched)
    sbounds = chunk_bounds if g == 1 else superchunk_bounds(chunk_bounds, g)
    if n_chunks == 1:
        return g, sbounds, None, None
    order, count = tile_chunk_order(phi, tmax, sbounds, tile_n)
    return g, sbounds, order, count


def heavy_first(count):
    """The order in which a launch works its tiles, (n_tiles,) int32: the
    tiles with the most schedule entries first (a stable sort of count,
    descending). Blocks start in index order and a tile's walk is as long
    as its schedule, so the longest walks start first and the short ones
    fill the card behind them; in index order the card ends on a few long
    walks started last (K1-K4 take it, the yardstick does not)."""
    return torch.argsort(count, descending=True, stable=True).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions

def _chunk_scores(rows, phi, tmax, c: int):
    """rows (4C, 10) @ phi (10, N) -> (valid (C, N), t (C, N), +inf where
    invalid): the exact divide form of intersect.py:_chunk_scores_t."""
    p = rows @ phi
    a, nt, nu, nv = p[:c], p[c:2 * c], p[2 * c:3 * c], p[3 * c:]
    nondeg = torch.abs(a) >= shapes.TRI_EPS
    inv_a = nondeg.to(torch.float32) / torch.where(nondeg, a, 1.0)
    t = nt * inv_a
    u = nu * inv_a
    v = -nv * inv_a
    valid = nondeg & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < tmax)
    return valid, torch.where(valid, t, float("inf"))


def _chunk_rows(coeffs, ci: int, chunk_t: int):
    return coeffs[:, ci * chunk_t:(ci + 1) * chunk_t].reshape(4 * chunk_t, 10)


def _closest_plain(coeffs, phi, tmax, n_chunks: int, chunk_t: int):
    n = phi.shape[1]
    best_t = torch.full((n,), float("inf"), device=phi.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=phi.device)
    for ci in range(n_chunks):
        _, t = _chunk_scores(_chunk_rows(coeffs, ci, chunk_t), phi, tmax,
                             chunk_t)
        loc_i = torch.argmin(t, dim=0)
        loc_t = torch.gather(t, 0, loc_i[None])[0]
        better = loc_t < best_t
        best_t = torch.where(better, loc_t, best_t)
        best_i = torch.where(better, (loc_i + ci * chunk_t).to(torch.int32),
                             best_i)
    return best_t, best_i


def _any_plain(coeffs, phi, tmax, n_chunks: int, chunk_t: int):
    hit = torch.zeros((phi.shape[1],), dtype=torch.bool, device=phi.device)
    for ci in range(n_chunks):
        valid, _ = _chunk_scores(_chunk_rows(coeffs, ci, chunk_t), phi, tmax,
                                 chunk_t)
        hit |= valid.any(dim=0)
    return hit


def closest_hit_ref(coeffs, phi, tmax, chunk_bounds):
    """Plain version of the closest-hit kernels: every chunk in index
    order, per chunk the min t and its first argmin, merged with a strict
    <, so ties keep the lowest index."""
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    return _closest_plain(coeffs, phi, tmax, n_chunks, chunk_t)


def any_hit_ref(coeffs, phi, tmax, chunk_bounds):
    """Plain version of the any-hit kernels: OR over chunks."""
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    return _any_plain(coeffs, phi, tmax, n_chunks, chunk_t)


# ---------------------------------------------------------------------------
# Kernel launches

_ENTRIES = {"closest": "closest_hit_launch", "any": "any_hit_launch",
            "exact": "closest_hit_exact_launch"}


def variant_name(query: str, streamed: bool) -> str:
    """The kernel's name in cuda_lib's counts: closest_hit, any_hit,
    either with _streamed, or closest_hit_exact (query "exact", resident
    only)."""
    if query not in _ENTRIES:
        raise ValueError(f"query is 'closest', 'any' or 'exact', got "
                         f"{query!r}")
    if query == "exact":
        if streamed:
            raise ValueError("the exact kernel has no streamed variant")
        return EXACT
    return f"{query}_hit_streamed" if streamed else f"{query}_hit"


# ---------------------------------------------------------------------------
# The preparation's kernels (csrc/prep.cu)

# _tile_entry's far-plane scale, f32(1 + AABB_EPS) as PyTorch rounds the
# python scalar it multiplies by, as the IEEE bits the schedule kernel takes
FAR_SCALE_BITS = torch.tensor(1.0 + shapes.AABB_EPS,
                              dtype=torch.float32).view(torch.int32).item()


def heavy_first_launch(count, n_box: int):
    """heavy_first(count) by heavy_first_kernel, for a contiguous (n_tiles,)
    int32 count of values in 0..n_box (a schedule's count) on the card."""
    if count.dim() != 1 or not 0 <= n_box <= MAX_SCHED:
        raise ValueError(f"count must be 1-d and n_box in 0..{MAX_SCHED}")
    tiles = torch.empty_like(count)
    if count.numel():
        cuda_lib.launch("heavy_first", count.device, [
            cuda_lib.operand(count, count.device, torch.int32), tiles],
            [count.shape[0], n_box])
    return tiles


def _walk_operands_cuda(name: str, phi, tmax, chunk_bounds, max_sched: int):
    dev, n = phi.device, phi.shape[-1]
    cuda_lib.operand(phi, dev, shape=(10, n), strided=True)
    chunk_bounds = cuda_lib.operand(chunk_bounds.contiguous(), dev)
    n_chunks = chunk_bounds.shape[0]
    g = -(-n_chunks // max_sched)
    if n_chunks == 1:
        return g, chunk_bounds, None, None, None
    sbounds = chunk_bounds
    if g > 1:
        sbounds = torch.empty((-(-n_chunks // g), 8), device=dev)
        cuda_lib.launch("superchunk", dev, [chunk_bounds, sbounds],
                        [n_chunks, g, sbounds.shape[0]])
    n_box, tile = sbounds.shape[0], BLOCKS[name]
    order = torch.empty((-(-n // tile), n_box), dtype=torch.int32,
                        device=dev)
    count = torch.empty((order.shape[0],), dtype=torch.int32, device=dev)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(n)
    if n:
        cuda_lib.launch("schedule", dev, [phi, tmax, sbounds, order, count],
                        [*phi.stride(), tmax.stride(0), n, tile, n_box,
                         FAR_SCALE_BITS])
    tiles = None if name == EXACT else heavy_first_launch(count, n_box)
    return g, sbounds, order, count, tiles


def walk_operands(name: str, phi, tmax, chunk_bounds,
                  max_sched: int = MAX_SCHED):
    """What the kernel `name` (of KERNELS) walks, as its launch takes it:
    (g, sbounds, order, count, tiles), the schedule of walk_schedule per
    block of BLOCKS[name] lanes and the order in which the launch works
    its tiles, heavy_first(count). tiles is None where there is no
    schedule (a one-chunk scene) and for the yardstick, which works its
    tiles in index order. On the card csrc/prep.cu builds them
    (superchunk_kernel at g > 1, schedule_kernel, heavy_first_kernel),
    bit for bit the plain versions', which run on any other device. Span
    query.schedule (utils/profiling)."""
    with profiling.span("query.schedule"):
        if phi.device.type == "cuda":
            return _walk_operands_cuda(name, phi, tmax, chunk_bounds,
                                       max_sched)
        g, sbounds, order, count = walk_schedule(phi, tmax, chunk_bounds,
                                                 max_sched, BLOCKS[name])
        tiles = (None if count is None or name == EXACT
                 else heavy_first(count))
        if count is not None:
            cuda_lib.plain("schedule")
            if g > 1:
                cuda_lib.plain("superchunk")
            if tiles is not None:
                cuda_lib.plain("heavy_first")
    return g, sbounds, order, count, tiles


def prepared_launch(query: str, coeffs, phi, tmax, chunk_bounds, *,
                    stream=None, max_sched: int = MAX_SCHED, stats=None):
    """Launch closest_hit (query "closest"), any_hit ("any") or
    closest_hit_exact ("exact", stream None or False) on CUDA operands,
    with the operands checked and the chunk schedule built now; returns
    the outputs, (best_t, best_i) or (hit,) (N = 0 launches nothing).
    stats (the streamed kernels, K2 and K4, only): an int64 (2,) tensor on
    the card to which the launch adds the chunks it copied and the (warp,
    chunk) scans it ran."""
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    if query == "exact" and stream is None:
        stream = False
    streamed = streamed_variant(coeffs.shape[1], stream, max_sched)
    name = variant_name(query, streamed)
    if phi.device.type != "cuda":
        raise ValueError(f"no intersection kernel for {phi.device}")
    if stats is not None and (
            not streamed or stats.dtype != torch.int64
            or stats.shape != (2,) or stats.device != phi.device):
        raise ValueError("stats is an int64 (2,) tensor beside phi, for "
                         "the streamed kernels only")
    n = phi.shape[1]
    if query == "any":
        outs = (torch.empty((n,), dtype=torch.bool, device=phi.device),)
    else:
        outs = (torch.empty((n,), dtype=torch.float32, device=phi.device),
                torch.empty((n,), dtype=torch.int32, device=phi.device))
    if not n:
        return outs
    ops = _cuda_operands(name, coeffs, phi, tmax, chunk_bounds, chunk_t)
    g, sbounds, order, count, tiles = walk_operands(name, phi, ops[2],
                                                    chunk_bounds, max_sched)
    cuda_lib.launch(name, phi.device,
                    [*ops, sbounds, order, count, tiles, *outs, stats],
                    [int(streamed), n, coeffs.shape[1], n_chunks, chunk_t, g,
                     sbounds.shape[0]], entry=_ENTRIES[query])
    profiling.count("query.lanes." + name, n)
    return outs


# ---------------------------------------------------------------------------
# The custom ops: tmax is always (N,); stream and max_sched as the
# wrappers take them. The CPU implementation is the plain version, the
# CUDA one the kernel (prepared_launch); no device falls back. Each checks
# the operands and resolves the variant, once a query.

_OPERANDS = ("(Tensor coeffs, Tensor phi, Tensor tmax, Tensor chunk_bounds, "
             "bool? stream, int max_sched)")


@torch.library.custom_op("tracer_tpu_torch::closest_hit", mutates_args=(),
                         device_types="cpu",
                         schema=_OPERANDS + " -> (Tensor, Tensor)")
def _closest_op(coeffs, phi, tmax, chunk_bounds, stream, max_sched):
    _, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    streamed = streamed_variant(coeffs.shape[1], stream, max_sched)
    name = variant_name("closest", streamed)
    cuda_lib.plain(name)
    profiling.count("query.lanes." + name, phi.shape[1])
    return _closest_plain(coeffs, phi, tmax, n_chunks, chunk_t)


@_closest_op.register_kernel("cuda")
def _closest_cuda(coeffs, phi, tmax, chunk_bounds, stream, max_sched):
    return prepared_launch("closest", coeffs, phi, tmax, chunk_bounds,
                           stream=stream, max_sched=max_sched)


@_closest_op.register_fake
def _closest_fake(coeffs, phi, tmax, chunk_bounds, stream, max_sched):
    n = phi.shape[1]
    return (phi.new_empty((n,)),
            phi.new_empty((n,), dtype=torch.int32))


@torch.library.custom_op("tracer_tpu_torch::any_hit", mutates_args=(),
                         device_types="cpu", schema=_OPERANDS + " -> Tensor")
def _any_op(coeffs, phi, tmax, chunk_bounds, stream, max_sched):
    _, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    streamed = streamed_variant(coeffs.shape[1], stream, max_sched)
    name = variant_name("any", streamed)
    cuda_lib.plain(name)
    profiling.count("query.lanes." + name, phi.shape[1])
    return _any_plain(coeffs, phi, tmax, n_chunks, chunk_t)


@_any_op.register_kernel("cuda")
def _any_cuda(coeffs, phi, tmax, chunk_bounds, stream, max_sched):
    return prepared_launch("any", coeffs, phi, tmax, chunk_bounds,
                           stream=stream, max_sched=max_sched)[0]


@_any_op.register_fake
def _any_fake(coeffs, phi, tmax, chunk_bounds, stream, max_sched):
    return phi.new_empty((phi.shape[1],), dtype=torch.bool)


# ---------------------------------------------------------------------------
# Dispatching wrappers: the options checked, tmax shaped to (N,), the rest
# to the op (or, with stats, to prepared_launch, which takes no CPU call)

def closest_hit(coeffs, phi, tmax, chunk_bounds, *, stream=None,
                max_sched: int = MAX_SCHED, stats=None):
    """Closest hit per ray: (best_t (N,) f32, best_i (N,) int32), through
    the op tracer_tpu_torch::closest_hit. stream: None (streamed above
    STREAM_MIN_T_PAD), True or False; max_sched: schedule entries per
    tile, 1..MAX_SCHED; stats: see prepared_launch (a CPU call takes
    none)."""
    _check_options(stream, max_sched)
    if stats is not None:   # outside the op: a launch with counters
        return prepared_launch("closest", coeffs, phi, tmax, chunk_bounds,
                               stream=stream, max_sched=max_sched,
                               stats=stats)
    return _closest_op(coeffs, phi, _lane_tmax(tmax, phi), chunk_bounds,
                       stream, max_sched)


def closest_hit_exact(coeffs, phi, tmax, chunk_bounds, *,
                      max_sched: int = MAX_SCHED):
    """closest_hit by the yardstick kernel (resident, block-granular cull,
    the divide on every triangle): what K1 and K2 must give in best_t bit
    for bit, and K3 and K4 in isfinite(best_t). A check, not a path: the
    smoke run, utils/kernel_timing.py and the card tests call it."""
    if phi.device.type != "cpu":
        return prepared_launch("exact", coeffs, phi, tmax, chunk_bounds,
                               max_sched=max_sched)
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    streamed_variant(coeffs.shape[1], False, max_sched)
    cuda_lib.plain(EXACT)
    return _closest_plain(coeffs, phi, tmax, n_chunks, chunk_t)


def any_hit(coeffs, phi, tmax, chunk_bounds, *, stream=None,
            max_sched: int = MAX_SCHED, stats=None):
    """Whether any triangle is hit before tmax, per ray: (N,) bool,
    through the op tracer_tpu_torch::any_hit. stream, max_sched and stats
    as for closest_hit."""
    _check_options(stream, max_sched)
    if stats is not None:
        return prepared_launch("any", coeffs, phi, tmax, chunk_bounds,
                               stream=stream, max_sched=max_sched,
                               stats=stats)[0]
    return _any_op(coeffs, phi, _lane_tmax(tmax, phi), chunk_bounds, stream,
                   max_sched)
