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
each visited chunk staged synchronously in shared memory) and streamed
(K2, K4: two shared-memory slots, the next chunk copied while the current
one is scanned). stream=None takes the streamed variant when T_pad >
STREAM_MIN_T_PAD, the TPU package's own switch point, so that both
packages take the same variant on the same scene. Both walk the same
per-tile schedule: superchunks of g = ceil(n_chunks / max_sched)
morton-consecutive chunks (superchunk_bounds), in the near-to-far order
of tile_chunk_order, built per CUDA block of BLOCK lanes. A one-chunk
scene gets no schedule and the kernel walks its chunk under the block
cull. The schedule only skips chunks no lane can reach, so every variant
gives the plain version's hits and best t (ties in t may pick another
index).

Dispatch: a tensor on the CPU goes to the plain version (closest_hit_ref,
any_hit_ref, the chunked exact-f32 form of tracer_tpu/ops/intersect.py);
a CUDA tensor launches the kernel or raises. The kernels are built with
nvcc at first use by ops/cuda_lib.py, with every other source under
csrc/, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_tpu_torch.ops import cuda_lib, shapes

# Lanes per CUDA block: the tile of the chunk schedule (csrc/intersect.cu
# kBlock, checked at load through kernel_block()).
BLOCK = 256
# Most schedule entries per tile (tracer_tpu's MAX_SCHED): chunks group
# into superchunks of g = ceil(n_chunks / max_sched).
MAX_SCHED = 64
# stream=None streams the coefficients above this many padded triangles.
STREAM_MIN_T_PAD = 65_536
# Shared memory per triangle of a staged chunk: 4 rows of 10 f32.
_TRI_BYTES = 4 * 10 * 4
# Largest chunk each variant takes: the resident kernel stages one chunk
# in the 48 KB a block gets without an opt-in, the streamed kernel two in
# the 227 KB (232,448 bytes) a block may opt in to.
MAX_CHUNK_T = {"resident": (48 * 1024) // _TRI_BYTES,
               "streamed": 232_448 // (2 * _TRI_BYTES)}
# Bound on the (chunks, lanes) f32 temporaries of one schedule batch.
_SCHED_ELEMS = 1 << 24

# Launches of each kernel, and calls of each variant's plain version. A
# wrapper adds one where it launches its kernel (or runs its plain
# version) and nowhere else; reset_counts() sets all to 0.
VARIANTS = ("closest_hit", "closest_hit_streamed", "any_hit",
            "any_hit_streamed")
launches = {k: 0 for k in VARIANTS}
plain_calls = {k: 0 for k in VARIANTS}


def reset_counts() -> None:
    for k in VARIANTS:
        launches[k] = 0
        plain_calls[k] = 0


# ---------------------------------------------------------------------------
# Build and load

@functools.cache
def build() -> ctypes.CDLL:
    """The kernels' library (ops/cuda_lib.load: every csrc source, built
    once per hash of the sources), with the intersection entry points
    declared and kBlock checked against BLOCK."""
    lib = cuda_lib.load()
    lib.kernel_block.argtypes = []
    lib.kernel_block.restype = ctypes.c_int
    if lib.kernel_block() != BLOCK:
        raise RuntimeError(f"csrc/intersect.cu has blocks of "
                           f"{lib.kernel_block()} lanes, the wrapper {BLOCK}")
    head = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    lib.closest_hit_launch.argtypes = head + [ctypes.c_void_p] * 3
    lib.closest_hit_launch.restype = ctypes.c_int
    lib.any_hit_launch.argtypes = head + [ctypes.c_void_p] * 2
    lib.any_hit_launch.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Argument checks

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
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    if tmax.dim() == 0:
        tmax = tmax.expand(n)
    if tmax.shape != (n,):
        raise ValueError(f"tmax must be a scalar or ({n},), got "
                         f"{tuple(tmax.shape)}")
    return tmax, n_chunks, t_pad // n_chunks


def streamed_variant(t_pad: int, stream=None, max_sched: int = MAX_SCHED
                     ) -> bool:
    """Check the walk options and resolve `stream`: True or False as
    given, None for streaming above STREAM_MIN_T_PAD padded triangles.
    max_sched (1..MAX_SCHED) bounds the schedule entries per tile."""
    if stream is not None and not isinstance(stream, bool):
        raise ValueError(f"stream must be None, True or False, got {stream!r}")
    if (isinstance(max_sched, bool) or not isinstance(max_sched, int)
            or not 1 <= max_sched <= MAX_SCHED):
        raise ValueError(f"max_sched must be an int in 1..{MAX_SCHED}, got "
                         f"{max_sched!r}")
    return t_pad > STREAM_MIN_T_PAD if stream is None else stream


def _cuda_operands(coeffs, phi, tmax, chunk_bounds, chunk_t, streamed):
    kind = "streamed" if streamed else "resident"
    if chunk_t > MAX_CHUNK_T[kind]:
        raise ValueError(f"chunk of {chunk_t} triangles exceeds the {kind} "
                         f"kernel's {MAX_CHUNK_T[kind]}")
    for name, x in (("coeffs", coeffs), ("phi", phi),
                    ("chunk_bounds", chunk_bounds)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if streamed and (coeffs.data_ptr() % 16 or chunk_t % 2):
        raise ValueError("the streamed kernel copies 16-byte pieces: coeffs "
                         "must be 16-byte aligned and chunk_t even")
    if phi.shape[1] >= 2 ** 31:
        raise ValueError("too many rays for int32 lane ids")
    return tmax.contiguous()


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


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


def walk_schedule(phi, tmax, chunk_bounds, max_sched: int = MAX_SCHED):
    """What a kernel walks: (g, superchunk bounds, order, count). At
    g = 1 the superchunks are the chunks; a one-chunk scene gets no
    schedule (order and count None)."""
    n_chunks = chunk_bounds.shape[0]
    g = -(-n_chunks // max_sched)
    sbounds = chunk_bounds if g == 1 else superchunk_bounds(chunk_bounds, g)
    if n_chunks == 1:
        return g, sbounds, None, None
    order, count = tile_chunk_order(phi, tmax, sbounds, BLOCK)
    return g, sbounds, order, count


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
# Dispatching wrappers

def _launch(entry, name, coeffs, phi, tmax, chunk_bounds, n_chunks, chunk_t,
            streamed, max_sched, outs):
    """Launch one kernel on CUDA operands, or raise. The schedule's
    tensors may be freed once the launch is queued: the caching allocator
    hands their memory only to work queued after it on the same stream."""
    tmax = _cuda_operands(coeffs, phi, tmax, chunk_bounds, chunk_t, streamed)
    g, sbounds, order, count = walk_schedule(phi, tmax, chunk_bounds,
                                             max_sched)
    err = entry(int(streamed), _ptr(coeffs), _ptr(phi), _ptr(tmax),
                _ptr(chunk_bounds), _ptr(sbounds), _ptr(order), _ptr(count),
                phi.shape[1], coeffs.shape[1], n_chunks, chunk_t, g,
                sbounds.shape[0], *map(_ptr, outs),
                cuda_lib.stream_ptr(phi.device))
    if err:
        raise RuntimeError(f"{name}_kernel launch failed: CUDA error {err}")
    launches[name] += 1


def closest_hit(coeffs, phi, tmax, chunk_bounds, *, stream=None,
                max_sched: int = MAX_SCHED):
    """Closest hit per ray: (best_t (N,) f32, best_i (N,) int32).
    stream: None (streamed above STREAM_MIN_T_PAD), True or False;
    max_sched: schedule entries per tile, 1..MAX_SCHED."""
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    streamed = streamed_variant(coeffs.shape[1], stream, max_sched)
    name = "closest_hit_streamed" if streamed else "closest_hit"
    if phi.device.type == "cpu":
        plain_calls[name] += 1
        return _closest_plain(coeffs, phi, tmax, n_chunks, chunk_t)
    if phi.device.type != "cuda":
        raise ValueError(f"no intersection kernel for {phi.device}")
    n = phi.shape[1]
    best_t = torch.empty((n,), dtype=torch.float32, device=phi.device)
    best_i = torch.empty((n,), dtype=torch.int32, device=phi.device)
    if n:
        _launch(build().closest_hit_launch, name, coeffs, phi, tmax,
                chunk_bounds, n_chunks, chunk_t, streamed, max_sched,
                (best_t, best_i))
    return best_t, best_i


def any_hit(coeffs, phi, tmax, chunk_bounds, *, stream=None,
            max_sched: int = MAX_SCHED):
    """Whether any triangle is hit before tmax, per ray: (N,) bool.
    stream and max_sched as for closest_hit."""
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    streamed = streamed_variant(coeffs.shape[1], stream, max_sched)
    name = "any_hit_streamed" if streamed else "any_hit"
    if phi.device.type == "cpu":
        plain_calls[name] += 1
        return _any_plain(coeffs, phi, tmax, n_chunks, chunk_t)
    if phi.device.type != "cuda":
        raise ValueError(f"no intersection kernel for {phi.device}")
    hit = torch.empty((phi.shape[1],), dtype=torch.bool, device=phi.device)
    if phi.shape[1]:
        _launch(build().any_hit_launch, name, coeffs, phi, tmax,
                chunk_bounds, n_chunks, chunk_t, streamed, max_sched, (hit,))
    return hit
