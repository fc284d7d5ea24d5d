"""Dense ray-triangle intersection (port of tracer_tpu/ops/intersect.py).

Every determinant of the Moller test is linear in the ray features
phi(ray) = [d, o, o x d, 1], so per triangle four 10-term coefficient
rows (a, n.s, m.e2, m.e1) score any ray with dot products. build_dense
sorts the triangles in morton order, pads them to whole chunks of pad_to
and records each chunk's box; closest_hit / any_hit hand the features to
the kernel wrappers of ops/intersect_kernel.py (the CUDA kernels on the
card, their plain versions on the CPU), and closest_hit recomputes the
winner's t, position and normal exactly from its index.

Boundary ray permutation (tracer_tpu/ops/intersect.py:262-406): at the
query boundary only, the lanes may be sorted by a coherence key
(perm_key) so that each CUDA block's rays are alike and its chunk
schedule culls; the kernel runs on the sorted lanes and its results are
scattered back to the caller's order. Lane state never moves. The
sorted lanes (sorted_lanes) come from the custom ops
tracer_tpu_torch::lane_key and lane_deal around one stable torch.sort:
on the CPU the plain version (perm_key, lane_order), on the card
csrc/prep.cu's key and deal kernels, bit for bit the same lanes with no
host read; the scene box of the odmorton key is DenseTris.scene_box,
derived once from the chunk boxes. perm="auto"
sorts on a CUDA tensor at PERM_AUTO_MIN_CHUNKS (closest) or
PERM_ANY_AUTO_MIN_CHUNKS (any hit) chunks and never on the CPU, as the
TPU package sorts only for its Pallas kernels; "off" never sorts; a key
name always does. Results do not depend on the lane order, except which
index wins an exact-t tie across chunks.

Dead lanes: a lane whose per-lane tmax is <= 0 hits nothing (the path
tracer's dead lanes, NEE's unused shadow lanes) and the kernels leave it
out of the walk. Every sorted query keys such lanes first, so that they
fill whole warps and blocks, which then copy and scan nothing; when the
live lanes are too few to fill the card, they are dealt out over
SPREAD_WARPS warps instead of packed into a few long walks. A query that
is not sorted is not partitioned either: below PERM_AUTO_MIN_CHUNKS the
sort, the gather and the two scatters cost more than the scan they save
(on an NVIDIA H100 at 700 W, over the 16 bounces of a 512x512 Cornell
frame: 3.48 ms against 0.96 ms for the wrapper on the lanes as they come;
utils/kernel_timing.bounce_times, PERF.md), so there the kernel alone
drops the dead lanes, warp by warp.

The port is exact f32 everywhere: the TPU package's bf16 word packing
and its Pallas switch are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import morton as morton_mod
from tracer_tpu_torch.ops import shapes
from tracer_tpu_torch.utils import profiling

# Chunk padding: small scenes pad to 128, larger ones to 256 triangles.
PAD = 128
PAD_LARGE = 256
PAD_LARGE_MIN_TRIS = 512
# tmax slack of the exact re-test of the winner (intersect.py:481)
REINTERSECT_SLACK = 1e-6
# perm="auto" thresholds, in chunks of the scene (intersect.py:291-292)
PERM_AUTO_MIN_CHUNKS = 16
PERM_ANY_AUTO_MIN_CHUNKS = 2
PERM_KEYS = ("oct", "dmorton", "odmorton")
# A sorted query with dead lanes deals its live lanes out over at least
# this many warps (lane_order); 0: pack them, dead lanes first. 4,096 is
# about the warps an H100 holds of the streamed kernels (132 SMs x 16
# blocks x 2 warps). Measured there at 700 W over the 16 bounces of a
# 512x512 cornell-sub6 frame (utils/kernel_timing.spread_sweep, the whole
# query with its sort and schedule): closest 151.6 ms packed, 123.1 at
# 2,048, 111.6 at 4,096 and at 8,192; any hit 128.0, 108.6, 110.8, 115.2.
SPREAD_WARPS = 4096


class DenseTris(nn.Module):
    """Precomputed triangle coefficients, as registered buffers.

    coeffs: (4, T_pad, 10) f32 blocks (a, n.s, m.e2, m.e1); columns in
            the order of phi = [d, o, o x d, 1]
    tris:   (T_pad, 10) f32 flattened vertices (9) + an aux scalar
            (column 9: the material id); zero rows are padding
    perm:   (T_pad,) int32, perm[i] = input index of stored triangle i
    chunk_bounds: (n_chunks, 8) f32 per-chunk box [min xyz, max xyz, 0,
            0]; padded chunks carry an inverted (+inf/-inf) box
    """

    def __init__(self, coeffs, tris, perm, chunk_bounds):
        super().__init__()
        self.register_buffer("coeffs", coeffs)
        self.register_buffer("tris", tris)
        self.register_buffer("perm", perm)
        self.register_buffer("chunk_bounds", chunk_bounds)
        # (6,) the key's scene box, derived once (not checkpointed)
        self.register_buffer("scene_box", scene_box(chunk_bounds),
                             persistent=False)


def default_pad(n_tris: int) -> int:
    return PAD_LARGE if n_tris > PAD_LARGE_MIN_TRIS else PAD


def build_dense(tris, pad_to: int | None = None, aux=None) -> DenseTris:
    """Coefficients of (T, 3, 3) triangles, morton-sorted with a stable
    argsort, padded to whole chunks of pad_to (default: 128, or 256 above
    512 triangles). aux: optional (T,) scalar stored in tris column 9.
    Built on the device of `tris`."""
    tris = torch.as_tensor(tris, dtype=torch.float32).reshape(-1, 3, 3)
    dev = tris.device
    t = tris.shape[0]
    aux = (torch.zeros((t,), device=dev) if aux is None
           else torch.as_tensor(aux, dtype=torch.float32, device=dev).reshape(t))
    if pad_to is None:
        pad_to = default_pad(t)
    if pad_to <= 0:
        raise ValueError(f"pad_to must be positive, got {pad_to}")
    t_pad = max(pad_to, -(-max(t, 1) // pad_to) * pad_to)

    if t > 1:
        tri_min = tris.amin(dim=-2)
        tri_max = tris.amax(dim=-2)
        smin = tri_min.amin(dim=0)
        dims = torch.clamp_min(tri_max.amax(dim=0) - smin, 1e-30)
        centers = ((tri_min + tri_max) * 0.5 - smin) / dims
        order = torch.argsort(morton_mod.morton3d(centers),
                              stable=True).to(torch.int32)
        tris = tris[order.long()]
        aux = aux[order.long()]
    else:
        order = torch.arange(t, dtype=torch.int32, device=dev)

    perm = torch.cat([order, torch.arange(t, t_pad, dtype=torch.int32,
                                          device=dev)])
    tris = torch.cat([tris, torch.zeros((t_pad - t, 3, 3), device=dev)])
    aux = torch.cat([aux, torch.zeros((t_pad - t,), device=dev)])

    n_chunks = t_pad // pad_to
    real = (torch.arange(t_pad, device=dev) < t)[:, None]
    inf = float("inf")
    cmin = torch.where(real, tris.amin(dim=-2), inf)
    cmax = torch.where(real, tris.amax(dim=-2), -inf)
    bmin = cmin.reshape(n_chunks, pad_to, 3).amin(dim=1)
    bmax = cmax.reshape(n_chunks, pad_to, 3).amax(dim=1)
    chunk_bounds = torch.cat(
        [bmin, bmax, torch.zeros((n_chunks, 2), device=dev)], dim=1)

    a_v = tris[:, 0, :]
    e1 = tris[:, 1, :] - a_v
    e2 = tris[:, 2, :] - a_v
    n = la.cross(e1, e2)
    axe1 = la.cross(a_v, e1)
    axe2 = la.cross(a_v, e2)
    zeros = torch.zeros((t_pad, 3), device=dev)
    zero = torch.zeros((t_pad, 1), device=dev)
    coeffs = torch.stack([
        torch.cat([-n, zeros, zeros, zero], dim=-1),                    # a
        torch.cat([zeros, n, zeros,
                   -torch.sum(n * a_v, -1, keepdim=True)], dim=-1),     # n.s
        torch.cat([axe2, zeros, e2, zero], dim=-1),                     # m.e2
        torch.cat([axe1, zeros, e1, zero], dim=-1),                     # m.e1
    ])
    tri_rows = torch.cat([tris.reshape(t_pad, 9), aux[:, None]], dim=1)
    return DenseTris(coeffs=coeffs.contiguous(), tris=tri_rows.contiguous(),
                     perm=perm, chunk_bounds=chunk_bounds.contiguous())


def ray_features_t(origin, d):
    """phi(ray) transposed: (10, N) = [d, o, o x d, 1] rows from V3 rays."""
    n = max(origin.shape[1], d.shape[1])
    origin = origin.expand(3, n)
    d = d.expand(3, n)
    ones = torch.ones((1, n), dtype=torch.float32, device=d.device)
    return torch.cat([d, origin, la.v3_cross(origin, d), ones], dim=0)


def _reintersect(tris, best_i, origin, d, tmax):
    """Exact t, position and normal of the winning triangle best_i of the
    rows tris (DenseTris.tris), and its aux scalar (returned last)."""
    rows_t = tris[best_i.long()].T  # (10, N)
    ok, t, pos, nrm = shapes.hit_triangle_v(tmax, origin, d, rows_t[0:3],
                                            rows_t[3:6], rows_t[6:9])
    return ok, t, pos, nrm, rows_t[9]


def _spread3(v, bits: int):
    r = torch.zeros_like(v)
    for i in range(bits):
        r = r | (((v >> i) & 1) << (3 * i))
    return r


def _quant_i(v, lo, hi, bits: int):
    """(v - lo) / (hi - lo) on 2**bits cells, in f32 as the TPU package's
    _quant_i computes it, truncated toward zero and clipped. The clamp
    before the conversion gives the same cell for every finite v and
    keeps out-of-range values from the undefined float-to-int cast."""
    scale = (torch.full_like(lo, float(1 << bits))
             / torch.clamp_min(hi - lo, 1e-30))
    q = (v - lo) * scale
    return torch.clamp(q, 0.0, float((1 << bits) - 1)).to(torch.int32)


def _morton3(x, y, z, lo, hi, bits: int):
    return ((_spread3(_quant_i(x, lo[0], hi[0], bits), bits) << 2)
            | (_spread3(_quant_i(y, lo[1], hi[1], bits), bits) << 1)
            | _spread3(_quant_i(z, lo[2], hi[2], bits), bits))


def scene_box(chunk_bounds):
    """The scene's box, the union of the non-empty chunk boxes: (6,) [min
    xyz, max xyz] (+inf / -inf where every chunk is empty)."""
    finite = (chunk_bounds[:, 0] <= chunk_bounds[:, 3])[:, None]
    lo = torch.where(finite, chunk_bounds[:, 0:3], float("inf")).amin(dim=0)
    hi = torch.where(finite, chunk_bounds[:, 3:6], -float("inf")).amax(dim=0)
    return torch.cat([lo, hi])


def _check_mode(mode: str) -> None:
    if mode not in PERM_KEYS:
        raise ValueError(f"unknown permutation key {mode!r}; expected one "
                         f"of {PERM_KEYS}")


def _box_key(phi, box, mode: str):
    """perm_key on the scene box (6,) of scene_box."""
    d0, o0 = phi[0:3], phi[3:6]
    if mode == "oct":
        return ((d0[0] >= 0).to(torch.int32) * 4
                + (d0[1] >= 0).to(torch.int32) * 2
                + (d0[2] >= 0).to(torch.int32))
    unit_lo = torch.full((3,), -1.0, device=phi.device)
    unit_hi = torch.full((3,), 1.0, device=phi.device)
    if mode == "dmorton":
        return _morton3(d0[0], d0[1], d0[2], unit_lo, unit_hi, 10)
    om = _morton3(o0[0], o0[1], o0[2], box[0:3], box[3:6], 5)
    dm = _morton3(d0[0], d0[1], d0[2], unit_lo, unit_hi, 5)
    return (om << 15) | dm


def perm_key(phi, chunk_bounds, mode: str):
    """Coherence sort key (N,) int32 of the ray features (10, N), bit for
    bit tracer_tpu's _perm_key:
      oct       3-bit direction octant
      dmorton   30-bit morton code of the direction on [-1, 1]^3
      odmorton  15-bit morton code of the origin on the scene's box (the
                union of the non-empty chunk boxes) over a 15-bit one of
                the direction.
    Unknown modes raise ValueError."""
    _check_mode(mode)
    return _box_key(phi, scene_box(chunk_bounds), mode)


def resolve_perm(perm: str, n_chunks: int, device, any_hit: bool = False):
    """The key name a query sorts by, or None. perm: "auto", "off" or a
    key of PERM_KEYS; anything else raises ValueError."""
    if perm == "off":
        return None
    if perm == "auto":
        need = PERM_ANY_AUTO_MIN_CHUNKS if any_hit else PERM_AUTO_MIN_CHUNKS
        on = torch.device(device).type == "cuda" and n_chunks >= need
        return "odmorton" if on else None
    if perm not in PERM_KEYS:
        raise ValueError(f"perm must be 'auto', 'off' or one of {PERM_KEYS}, "
                         f"got {perm!r}")
    return perm


def lane_order(phi, tmax, chunk_bounds, mode: str, dead_first: bool = False):
    """The lane permutation of a sorted query: indices (N,) that sort the
    lanes by perm_key with a stable sort; dead_first keys the lanes with
    tmax <= 0 as -1, so they come first.

    With dead_first and SPREAD_WARPS > 0: when the L live lanes would fill
    fewer than SPREAD_WARPS warps, they are dealt out instead in key
    order, k = ceil(L / SPREAD_WARPS) to a warp, each warp of 32 filled
    up with dead lanes (as far as there are any), from lane 0 on; the
    dead lanes left over follow. No host read: L and k stay on the
    device. A block's walk is the union of its lanes' chunks and a launch
    ends on its longest walk, so a few hundred live lanes packed into a
    few blocks take as long as a full tile, and one to a warp a fraction
    of it."""
    key = perm_key(phi, chunk_bounds, mode)
    if not dead_first:
        return torch.sort(key, stable=True).indices
    live = tmax > 0.0
    idx = torch.sort(torch.where(live, key, -1), stable=True).indices
    return _deal(idx, phi.shape[1] - live.sum(), SPREAD_WARPS)


def _deal(idx, n_dead, spread: int):
    """lane_order's deal of the lanes idx, sorted dead first, n_dead (a
    0-d int64 tensor) of them dead, over `spread` warps (0: as they are)."""
    if not spread:
        return idx
    n = idx.shape[0]
    n_live = n - n_dead
    k = torch.clamp((n_live + spread - 1) // spread, 1, 32)
    rank = torch.arange(n, device=idx.device)
    j = rank - n_dead                     # live rank of the sorted lanes
    # dead rank r sorts at 2r + 1, the live lanes of warp w before the
    # dead lane that is the w * (32 - k)-th: 32 - k dead lanes pad each
    # warp; at k = 32 every live lane sorts after every dead one
    before = torch.where(k == 32, n_dead,
                         torch.div(j, k, rounding_mode="floor") * (32 - k))
    slot = torch.where(j >= 0, 2 * before, 2 * rank + 1)
    return idx[torch.sort(slot, stable=True).indices]


# ---------------------------------------------------------------------------
# The sorted query's preparation as the custom ops tracer_tpu_torch::lane_key
# and tracer_tpu_torch::lane_deal: the CPU implementation is the plain
# version above, the CUDA one csrc/prep.cu's lane_key_kernel and
# lane_deal_kernel (bit for bit the plain version's, no host read); no
# device falls back. Between them the stable sort of the keys stays one
# torch.sort. The fake rules give torch.export the shapes, so an exported
# step holds both ops. Each sorted query adds its lanes to the counter
# query.prep.kernel (the kernels did its preparation) or query.prep.plain.

_KEY_SCHEMA = ("(Tensor phi, Tensor tmax, Tensor box, str mode, "
               "bool dead_first) -> (Tensor, Tensor)")
_DEAL_SCHEMA = ("(Tensor idx, Tensor n_dead, Tensor phi, Tensor tmax, "
                "int spread) -> (Tensor, Tensor, Tensor)")


@torch.library.custom_op("tracer_tpu_torch::lane_key", mutates_args=(),
                         device_types="cpu", schema=_KEY_SCHEMA)
def _lane_key_op(phi, tmax, box, mode, dead_first):
    _check_mode(mode)
    cuda_lib.plain("lane_key")
    profiling.count("query.prep.plain", phi.shape[1])
    key = _box_key(phi, box, mode)
    if not dead_first:
        return key, torch.zeros((1,), dtype=torch.int32)
    live = tmax > 0.0
    n_dead = phi.shape[1] - live.sum(dtype=torch.int32)
    return torch.where(live, key, -1), n_dead.reshape(1)


@_lane_key_op.register_kernel("cuda")
def _lane_key_cuda(phi, tmax, box, mode, dead_first):
    _check_mode(mode)
    key, n_dead = _lane_key_fake(phi, tmax, box, mode, dead_first)
    n, dev = phi.shape[1], phi.device
    cuda_lib.launch("lane_key", dev, [
        *_lanes_operands(phi, tmax),
        cuda_lib.operand(box.contiguous(), dev, shape=(6,)), key, n_dead],
        [*phi.stride(), tmax.stride(0), n, PERM_KEYS.index(mode),
         int(dead_first)])
    profiling.count("query.prep.kernel", n)
    return key, n_dead


@_lane_key_op.register_fake
def _lane_key_fake(phi, tmax, box, mode, dead_first):
    return (phi.new_empty((phi.shape[1],), dtype=torch.int32),
            phi.new_empty((1,), dtype=torch.int32))


@torch.library.custom_op("tracer_tpu_torch::lane_deal", mutates_args=(),
                         device_types="cpu", schema=_DEAL_SCHEMA)
def _lane_deal_op(idx, n_dead, phi, tmax, spread):
    cuda_lib.plain("lane_deal")
    order = _deal(idx, n_dead[0].long(), spread)
    if order is idx:   # an op's output may not alias its input
        order = idx.clone()
    return order, phi[:, order], tmax[order]


@_lane_deal_op.register_kernel("cuda")
def _lane_deal_cuda(idx, n_dead, phi, tmax, spread):
    order, phi_s, tmax_s = _lane_deal_fake(idx, n_dead, phi, tmax, spread)
    n, dev = phi.shape[1], phi.device
    # the sorted index is a contiguous (N,) int64, n_dead a (1,) int32
    cuda_lib.launch("lane_deal", dev, [
        cuda_lib.operand(idx, dev, torch.int64, (n,)),
        cuda_lib.operand(n_dead, dev, torch.int32, (1,)),
        *_lanes_operands(phi, tmax), order, phi_s, tmax_s],
        [*phi.stride(), tmax.stride(0), n, spread])
    return order, phi_s, tmax_s


@_lane_deal_op.register_fake
def _lane_deal_fake(idx, n_dead, phi, tmax, spread):
    n = phi.shape[1]
    return (idx.new_empty((n,)), phi.new_empty((10, n)),
            phi.new_empty((n,)))


def _lanes_operands(phi, tmax) -> list:
    """phi (10, N) and tmax (N,), f32 on phi's device, each read through
    its strides, checked; lane ids are int32."""
    n, dev = phi.shape[-1], phi.device
    if n >= 2 ** 31:
        raise ValueError("too many rays for int32 lane ids")
    return [cuda_lib.operand(phi, dev, shape=(10, n), strided=True),
            cuda_lib.operand(tmax, dev, shape=(n,), strided=True)]


def sorted_lanes(dense: DenseTris, phi, tmax, mode: str, dead_first: bool):
    """A sorted query's lanes: (order, phi[:, order], tmax[order]) with
    order = lane_order(phi, tmax, dense.chunk_bounds, mode, dead_first),
    through the ops lane_key and lane_deal around a stable torch.sort;
    tmax a scalar or (N,)."""
    n = phi.shape[1]
    tmax = tmax.expand(n)
    key, n_dead = torch.ops.tracer_tpu_torch.lane_key(
        phi, tmax, dense.scene_box, mode, dead_first)
    idx = torch.sort(key, stable=True).indices
    return torch.ops.tracer_tpu_torch.lane_deal(
        idx, n_dead, phi, tmax, SPREAD_WARPS if dead_first else 0)


def closest_hit_phi(dense: DenseTris, tmax, phi, *, perm: str = "auto",
                    stream=None, max_sched: int = ik.MAX_SCHED):
    """The closest-hit kernel wrapper on ray features phi (10, N), run on
    lanes sorted by the perm key when `perm` resolves to one, the dead
    lanes of a per-lane tmax (<= 0) first; (best_t, best_i) come back in
    the caller's lane order. stream and max_sched go to ik.closest_hit.
    A sorted query is span query.sort (utils/profiling), from the key
    through the sort, the gather, the kernel wrapper (its query.schedule
    span inside) and the scatter back."""
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    per_lane = tmax.dim() > 0
    mode = resolve_perm(perm, dense.chunk_bounds.shape[0], phi.device)
    kw = {"stream": stream, "max_sched": max_sched}
    if mode is None:
        return ik.closest_hit(dense.coeffs, phi, tmax, dense.chunk_bounds,
                              **kw)
    with profiling.span("query.sort"):
        idx, phi_s, tmax_s = sorted_lanes(dense, phi, tmax, mode, per_lane)
        bt_s, bi_s = ik.closest_hit(dense.coeffs, phi_s, tmax_s,
                                    dense.chunk_bounds, **kw)
        best_t, best_i = torch.empty_like(bt_s), torch.empty_like(bi_s)
        best_t[idx] = bt_s
        best_i[idx] = bi_s
    return best_t, best_i


def any_hit_phi(dense: DenseTris, tmax, phi, *, perm: str = "auto",
                stream=None, max_sched: int = ik.MAX_SCHED):
    """The any-hit kernel wrapper on ray features phi (10, N), run on
    sorted lanes as closest_hit_phi does; dead lanes (tmax <= 0) key -1,
    so they sort first and fill whole blocks that schedule nothing. A
    sorted query is span query.sort, as in closest_hit_phi."""
    mode = resolve_perm(perm, dense.chunk_bounds.shape[0], phi.device,
                        any_hit=True)
    n = phi.shape[1]
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=phi.device).expand(n)
    kw = {"stream": stream, "max_sched": max_sched}
    if mode is None:
        return ik.any_hit(dense.coeffs, phi, tmax, dense.chunk_bounds, **kw)
    with profiling.span("query.sort"):
        idx, phi_s, tmax_s = sorted_lanes(dense, phi, tmax, mode, True)
        hit_s = ik.any_hit(dense.coeffs, phi_s, tmax_s, dense.chunk_bounds,
                           **kw)
        hit = torch.empty_like(hit_s)
        hit[idx] = hit_s
    return hit


def closest_hit(dense: DenseTris, tmax, origin, d, *, perm: str = "auto",
                then=None):
    """Closest-hit query of V3 rays (3,N) against all triangles; perm as
    for closest_hit_phi.

    Returns (ok (N,), t (N,), tri_idx (N,) int32 in storage order, -1 on
    a miss, pos (3,N), normal (3,N), aux (N,) f32, 0 on a miss). Or,
    given then, then(best_t, best_i, tmax) of the query's answer in place
    of the re-test below (models/scene.closest_interaction: the op
    tracer_tpu_torch::interaction, whose [1] is this t; portbench's traced
    call reads the rays and t of this function's calls)."""
    phi = ray_features_t(origin, d)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    best_t, best_i = closest_hit_phi(dense, tmax, phi, perm=perm)
    if then is not None:
        return then(best_t, best_i, tmax)
    ok = torch.isfinite(best_t)
    best_i = torch.where(ok, best_i, 0)
    ok2, t, pos, normal, aux = _reintersect(
        dense.tris, best_i, origin, d, tmax * (1.0 + REINTERSECT_SLACK))
    ok = ok & ok2
    return (ok, torch.where(ok, t, float("inf")),
            torch.where(ok, best_i, -1), pos, normal,
            torch.where(ok, aux, 0.0))


def any_hit(dense: DenseTris, tmax, origin, d, *, perm: str = "auto"):
    """Shadow-ray query: True where any triangle is hit before tmax; perm
    as for any_hit_phi."""
    return any_hit_phi(dense, tmax, ray_features_t(origin, d), perm=perm)


def closest_hit_bruteforce(tris, tmax, origin, d):
    """Pure-broadcast oracle over (N, 3) rays and (T, 3, 3) triangles;
    O(N*T) memory, test-sized inputs only. Returns (hit, best_t,
    best_i in input order, -1 on a miss)."""
    _, t, _, _ = shapes.hit_triangle(tmax, origin[..., None, :],
                                     d[..., None, :], tris)
    best_i = torch.argmin(t, dim=-1).to(torch.int32)
    best_t = t.amin(dim=-1)
    hit = torch.isfinite(best_t)
    return hit, best_t, torch.where(hit, best_i, -1)
