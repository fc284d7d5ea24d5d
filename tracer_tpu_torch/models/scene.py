"""Scene assembly: triangles + material table + lights + the
acceleration structure (port of tracer_tpu/models/scene.py).

The scene is an nn.Module whose tensors are registered buffers, so
`.to(device)` moves it whole. The accel is the dense intersector
(ops/intersect.py: K1-K4 on the card) or the LBVH (ops/bvh.py: its walk
K14/K15 on the card). "auto" is the dense accel up to DENSE_THRESHOLD
triangles, the size it is verified at, and the LBVH above it. This
departs from the JAX package on purpose: its "auto" refuses such a
scene, since its LBVH walk has no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tracer_tpu_torch.engine import interaction
from tracer_tpu_torch.models import lights as lights_mod
from tracer_tpu_torch.ops import bvh as bvh_mod
from tracer_tpu_torch.ops import intersect, materials

DENSE_THRESHOLD = 2_500_000


class Scene(nn.Module):
    """tris (T, 3, 3); mat_ix (max(T,1),) input-order material ids;
    mat_rows (max(M,1), 28); tri_mat (max(T,1),) material id per triangle
    in the order of the accel's returned triangle index; lights;
    light_table (L, 23) packed [tri 9 | emission 12 | theta | kind];
    accel a DenseTris or an LBVH."""

    def __init__(self, tris, mat_ix, mat_rows, tri_mat, lights, light_table,
                 accel):
        super().__init__()
        self.register_buffer("tris", tris)
        self.register_buffer("mat_ix", mat_ix)
        self.register_buffer("mat_rows", mat_rows)
        self.register_buffer("tri_mat", tri_mat)
        self.register_buffer("light_table", light_table)
        self.materials = materials.parse_mats(mat_rows)
        self.lights = lights
        self.accel = accel


def extract_lights(tris_np, tri_mats_np, mat_rows_np) -> lights_mod.Lights:
    """Emissive triangles on the host: a material is emissive when any
    knot has wavelength >= 0 and intensity > 0."""
    mat_rows_np = np.asarray(mat_rows_np, np.float32)
    emission = mat_rows_np[:, 16:28].reshape(-1, 6, 2)
    emissive_mat = ((emission[:, :, 0] >= 0)
                    & (emission[:, :, 1] > 0)).any(axis=1)
    tri_mats_np = np.asarray(tri_mats_np, np.int64)
    sel = np.nonzero(emissive_mat[tri_mats_np])[0]
    if sel.size == 0:
        return lights_mod.empty_lights()
    return lights_mod.Lights(
        kind=np.full((sel.size,), lights_mod.KIND_DIFFUSE_AREA, np.int32),
        tri=np.asarray(tris_np, np.float32)[sel],
        theta=np.zeros((sel.size,), np.float32),
        emission=emission[tri_mats_np[sel]])


def pack_light_table(lights: lights_mod.Lights) -> torch.Tensor:
    """(L, 23) f32 rows [tri(9) | emission knots(12) | theta | kind]."""
    n = lights.count
    return torch.cat([
        lights.tri.reshape(n, 9),
        lights.emission.reshape(n, 12),
        lights.theta[:, None],
        lights.kind.to(torch.float32)[:, None],
    ], dim=1)


def add_point_light(scene: Scene, pos, emission) -> Scene:
    """A scene with a point light appended to the light set (port of
    tracer_tpu/models/scene.py:add_point_light). The loaders never emit
    point lights; this is the API for them. pos: (3,) world position,
    held by vertex 0 of a degenerate triangle; emission: (6, 2) spectrum
    knots. The new scene shares every other tensor with `scene`."""
    dev = scene.tris.device
    old = scene.lights
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
    knots = torch.as_tensor(np.asarray(emission, np.float32), device=dev)
    lights = lights_mod.Lights(
        kind=torch.cat([old.kind, torch.tensor(
            [lights_mod.KIND_POINT], dtype=torch.int32, device=dev)]),
        tri=torch.cat([old.tri, pos.expand(1, 3, 3)]),
        theta=torch.cat([old.theta, torch.zeros((1,), device=dev)]),
        emission=torch.cat([old.emission, knots.reshape(1, 6, 2)]))
    return Scene(tris=scene.tris, mat_ix=scene.mat_ix,
                 mat_rows=scene.mat_rows, tri_mat=scene.tri_mat,
                 lights=lights, light_table=pack_light_table(lights),
                 accel=scene.accel)


def build_scene(tris_np, tri_mats_np, mat_rows_np, accel: str = "auto", *,
                device) -> Scene:
    """Assemble a scene from loader arrays on `device`: tris (T, 3, 3) f32,
    tri_mats (T,) u32, mat_rows (M, 28) f32. accel: "dense", "lbvh" or
    "auto" (the dense accel up to DENSE_THRESHOLD triangles, the LBVH
    above)."""
    tris_np = np.asarray(tris_np, np.float32).reshape(-1, 3, 3)
    tri_mats_np = np.asarray(tri_mats_np, np.int64)
    mat_rows_np = np.asarray(mat_rows_np, np.float32).reshape(-1, 28)
    t = tris_np.shape[0]
    mat_ix_padded = tri_mats_np if t > 0 else np.zeros((1,), np.int64)
    if mat_rows_np.shape[0] == 0:
        mat_rows_np = np.zeros((1, 28), np.float32)
    if accel == "auto":
        accel = "lbvh" if t > DENSE_THRESHOLD else "dense"
    tris = torch.as_tensor(tris_np, device=device)
    # tri_mat is indexed by the accel's returned triangle index: the dense
    # intersector stores its triangles in morton order, the LBVH maps its
    # hits back to input order itself
    if accel == "dense":
        acc = intersect.build_dense(
            tris, aux=torch.as_tensor(mat_ix_padded[:t].astype(np.float32),
                                      device=device))
        if t > 0:
            order = acc.perm[:t].long().cpu().numpy()
            row_ix = mat_ix_padded[order]
        else:
            row_ix = mat_ix_padded
    elif accel == "lbvh":
        acc = bvh_mod.build(tris)
        row_ix = mat_ix_padded
    else:
        raise ValueError(f"unknown accel {accel!r}")
    lights = extract_lights(tris_np, tri_mats_np, mat_rows_np).to(device)
    return Scene(
        tris=tris,
        mat_ix=torch.as_tensor(mat_ix_padded, dtype=torch.int32,
                               device=device),
        mat_rows=torch.as_tensor(mat_rows_np, device=device),
        tri_mat=torch.as_tensor(row_ix, dtype=torch.int32, device=device),
        lights=lights,
        light_table=pack_light_table(lights),
        accel=acc)


def closest_hit(scene: Scene, tmax, origin, d):
    """Rays are V3 (3,N); returns (ok, t, tri_idx, pos (3,N), normal (3,N))
    with tri_idx in the accel's order: storage (morton) order for the
    dense accel, input order for the LBVH."""
    if isinstance(scene.accel, intersect.DenseTris):
        return intersect.closest_hit(scene.accel, tmax, origin, d)[:5]
    return bvh_mod.closest_hit(scene.accel, tmax, origin, d)


def any_hit(scene: Scene, tmax, origin, d):
    """Shadow query; rays are V3 (3,N)."""
    if isinstance(scene.accel, intersect.DenseTris):
        return intersect.any_hit(scene.accel, tmax, origin, d)
    return bvh_mod.any_hit(scene.accel, tmax, origin, d)


class Interaction(NamedTuple):
    """Per-lane surface interaction."""
    ok: torch.Tensor       # (N,) bool
    t: torch.Tensor        # (N,)
    pos: torch.Tensor      # V3 (3, N)
    normal: torch.Tensor   # V3 (3, N)
    mat: materials.MaterialLanes
    emission_at_wl: torch.Tensor  # (N,) emission at the hero wavelength


def closest_interaction(scene: Scene, tmax, origin, d, wavelen) -> Interaction:
    """closest_hit + material row fetch at the hero wavelength: the
    query, then the op tracer_tpu_torch::interaction (engine/interaction.py,
    K16 on the card) on its answer. The material id rides the dense
    accel's aux column, and comes from tri_mat by the LBVH's triangle
    index."""
    acc = scene.accel
    if isinstance(acc, intersect.DenseTris):
        out = intersect.closest_hit(
            acc, tmax, origin, d, then=lambda best_t, best_i, tm:
            interaction.dense(acc, scene.mat_rows, tm, origin, d, wavelen,
                              best_t, best_i))
    else:
        out = bvh_mod.closest_hit(
            acc, tmax, origin, d, then=lambda leaf, tm: interaction.lbvh(
                acc, scene.tri_mat, scene.mat_rows, tm, origin, d, wavelen,
                leaf))
    ok, t, pos, normal, rows = out
    *mat, emission = rows.unbind(0)
    return Interaction(ok=ok, t=t, pos=pos, normal=normal,
                       mat=materials.MaterialLanes(*mat),
                       emission_at_wl=emission)
