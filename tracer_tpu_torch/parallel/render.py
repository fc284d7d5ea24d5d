"""Multi-device rendering on torch.distributed (port of
tracer_tpu/parallel/render.py).

A (tile, sample) grid of ranks, one process per device, each making the
same call (SPMD, as under torchrun):
  "tile"    image rows split over the tile axis: rank (ti, si) renders
            rows ti * rows .. (ti + 1) * rows of the frame
  "sample"  replicas of the frame on independent sample streams, averaged
            (images) or merged by the closest return (points)
Scene, accel and camera are replicated. Every rank returns the whole
result, as the JAX package's shard_map with out_specs=P("tile") does.

The collectives are all_reduce alone (SUM, MIN, MAX), each one span
mesh.reduce with its bytes in the counter mesh.reduce_bytes: the tile
axis is assembled as a SUM of zero frames into which each rank wrote its
own rows (x + 0.0 is exact, so a tile-only mesh gives the single render
bit for bit). gloo handles CUDA tensors for all_reduce and broadcast only,
and NCCL refuses two ranks on one device: with all_reduce alone the same
code runs on gloo on the CPU, on gloo with several ranks sharing one
card, and on NCCL with one card per rank. The caller picks the backend
when it initialises the process group; nothing here changes backend,
device or collective.

The JAX twin keys cached executables on the environment knobs its
integrator reads while tracing (_TRACE_KNOBS, _knob_key, lru_cache). The
port traces nothing and reads no environment, so it has no such cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from tracer_tpu_torch.engine import api, integrator
from tracer_tpu_torch.engine.state import EngineState
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.utils import profiling


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (tile, sample) grid: rank ti * n_sample +
    si of `group` holds cell (ti, si), the order of the JAX twin's
    reshape(devices, (n_tile, n_sample)). sample_group holds the n_sample
    ranks of this rank's tile."""
    group: dist.ProcessGroup
    n_tile: int
    n_sample: int
    ti: int
    si: int
    sample_group: dist.ProcessGroup


def make_mesh(n_tile: int, n_sample: int = 1, group=None) -> Mesh:
    """A (tile, sample) mesh over the ranks of `group` (the default
    group when None), which must number n_tile * n_sample; pass a
    subgroup to use fewer ranks. Every rank of the default group calls
    it, since dist.new_group is collective there."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    n = n_tile * n_sample
    if len(ranks) != n:
        raise ValueError(f"a {n_tile} x {n_sample} mesh needs {n} ranks, "
                         f"the group has {len(ranks)}")
    sample_groups = [dist.new_group(ranks[ti * n_sample:(ti + 1) * n_sample])
                     for ti in range(n_tile)]
    ti, si = divmod(ranks.index(dist.get_rank()), n_sample)
    return Mesh(group, n_tile, n_sample, ti, si, sample_groups[ti])


def _rows(mesh: Mesh, h: int, spp: int | None = None) -> int:
    """Rows of a tile; raises ValueError as the JAX twin does when the
    tile axis does not divide h or the sample axis spp."""
    if h % mesh.n_tile != 0:
        raise ValueError(f"height {h} not divisible by tile axis "
                         f"{mesh.n_tile}")
    if spp is not None and spp % mesh.n_sample != 0:
        raise ValueError(f"spp {spp} not divisible by sample axis "
                         f"{mesh.n_sample}")
    return h // mesh.n_tile


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    """dist.all_reduce of t in place: span mesh.reduce, and its bytes
    added to the counter mesh.reduce_bytes (utils/profiling). The span
    is the host's: on NCCL the call returns once the collective is
    queued on the device."""
    with profiling.span("mesh.reduce"):
        dist.all_reduce(t, op=op, group=group)
    profiling.count("mesh.reduce_bytes", t.numel() * t.element_size())


def _assemble(tile: torch.Tensor, mesh: Mesh, h: int,
              write: bool = True) -> torch.Tensor:
    """The (h, ...) frame: a SUM over the mesh of zero frames into which
    each rank wrote its tile (a rank with write=False writes nothing)."""
    full = tile.new_zeros((h, *tile.shape[1:]))
    if write:
        rows = tile.shape[0]
        full[mesh.ti * rows:(mesh.ti + 1) * rows] = tile
    _all_reduce(full, group=mesh.group)
    return full


def _mean_frame(img: torch.Tensor, mesh: Mesh, h: int) -> torch.Tensor:
    """The replicas' mean over the sample axis of each tile's rows, the
    whole frame on every rank (the JAX twin's pmean and out_specs)."""
    return _assemble(img, mesh, h) / mesh.n_sample


def _render_tile(s: EngineState, mesh: Mesh, nonce: int, spp: int,
                 with_points: bool = False):
    """integrator.render_pooled of this rank's tile: spp samples from
    `nonce` of rows ti * rows .. (ti + 1) * rows of the frame."""
    w, h = s.sub_dims
    rows = h // mesh.n_tile
    return integrator.render_pooled(
        s.seed, nonce & prng.MASK, s.scene, s.cam, s.ambience, w, rows,
        s.transmitter_kind, spp, s.render_mode, row0=mesh.ti * rows,
        full_h=h, with_points=with_points)


def render_pooled_sharded(s: EngineState, mesh: Mesh, spp: int):
    """The pooled render (integrator.render_pooled) over the mesh: rows
    over the tile axis, the spp budget over the sample axis, replica si
    rendering samples si * spp_local .. (si + 1) * spp_local, the streams
    a single device draws for spp samples in order. Returns the (h, w, 3)
    image, the mean of the replica means."""
    h = s.sub_dims[1]
    _rows(mesh, h, spp)
    spp_local = spp // mesh.n_sample
    img = _render_tile(s, mesh, s.nonce + mesh.si * spp_local, spp_local)
    return _mean_frame(img["img"], mesh, h)


def merge_points_newest(pos, distance, inten, si: int, mesh: Mesh):
    """Closest-return merge over the sample axis: the least distance
    wins, and an exact tie keeps the NEWEST replica (the highest si, whose
    samples come last), moving that replica's whole point by a one-hot
    SUM, never a coordinate-wise max of two returns. pos (3, N),
    distance and inten (N,). Returns (pos, inten, best_d); a pixel
    without a return has best_d = inf."""
    g = mesh.sample_group
    best_d = distance.clone()
    _all_reduce(best_d, dist.ReduceOp.MIN, g)
    mine = distance <= best_d
    win = torch.where(mine, si, -1).to(torch.int32)
    _all_reduce(win, dist.ReduceOp.MAX, g)
    sel = mine & (win == si)
    point = torch.where(sel, torch.cat([pos, inten[None]]), 0.0)
    _all_reduce(point, group=g)
    return point[:3], point[3], best_d


def sample_points_sharded(s: EngineState, mesh: Mesh, spp: int):
    """The LiDAR capture over the mesh: rows over the tile axis, the spp
    budget over the sample axis (samples as in render_pooled_sharded),
    replicas merged by merge_points_newest. Returns (h, w, 4) [x, y, z,
    intensity], intensity scaled by 1/spp; a pixel without a return is
    (-1, -1, -1, 0). The state's nonce is not advanced."""
    w, h = s.sub_dims
    rows = _rows(mesh, h, spp)
    spp_local = spp // mesh.n_sample
    out = _render_tile(s, mesh, s.nonce + mesh.si * spp_local, spp_local,
                       with_points=True)
    pos, inten, best_d = merge_points_newest(*out["points"], mesh.si, mesh)
    has = torch.isfinite(best_d)
    pts = torch.cat([la.v3_to_array(torch.where(has, pos, -1.0)),
                     torch.where(has, inten, 0.0)[:, None]], dim=-1)
    # a replica's intensity scale is 1/spp_local; correct it to 1/spp
    pts[:, 3] *= spp_local / spp
    pts = pts.reshape(rows, w, 4)
    # the replicas of a tile hold the same points: one of them writes
    return _assemble(pts, mesh, h, write=mesh.si == 0)


def step_sharded(s: EngineState, mesh: Mesh) -> EngineState:
    """api.step over the mesh: one 1-spp frame, rows over the tile axis,
    averaged over the sample axis, replica si on nonce nonce * n_sample
    + si (the JAX twin's sharded_frame_fn: not render_pooled_sharded's
    nonce + si * spp_local); then step's accumulation rule."""
    h = s.sub_dims[1]
    _rows(mesh, h)
    img = _render_tile(s, mesh, s.nonce * mesh.n_sample + mesh.si, 1)["img"]
    return api.merge_frame(s, _mean_frame(img, mesh, h))
