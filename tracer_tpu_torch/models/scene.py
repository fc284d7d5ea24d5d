"""Scene assembly: triangles + material table + lights + the dense
intersector (port of tracer_tpu/models/scene.py).

The scene is an nn.Module whose tensors are registered buffers, so
`.to(device)` moves it whole. Only the dense accel is ported; the LBVH
(and "auto" above DENSE_THRESHOLD triangles) raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tracer_tpu_torch.models import lights as lights_mod
from tracer_tpu_torch.ops import intersect, materials

DENSE_THRESHOLD = 2_500_000
# Above this many chunks the JAX package walks superchunks (MAX_SCHED) and,
# larger still, streams coefficients; neither is ported yet.
MAX_CHUNKS = 64


class Scene(nn.Module):
    """tris (T, 3, 3); mat_ix (max(T,1),) input-order material ids;
    mat_rows (max(M,1), 28); tri_mat (max(T,1),) material id per triangle
    in the accel's storage order; lights; light_table (L, 23) packed
    [tri 9 | emission 12 | theta | kind]; accel the DenseTris."""

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


def build_scene(tris_np, tri_mats_np, mat_rows_np, accel: str = "auto", *,
                device) -> Scene:
    """Assemble a scene from loader arrays on `device`: tris (T, 3, 3) f32,
    tri_mats (T,) u32, mat_rows (M, 28) f32. accel: "dense" or "auto"."""
    tris_np = np.asarray(tris_np, np.float32).reshape(-1, 3, 3)
    tri_mats_np = np.asarray(tri_mats_np, np.int64)
    mat_rows_np = np.asarray(mat_rows_np, np.float32).reshape(-1, 28)
    t = tris_np.shape[0]
    mat_ix_padded = tri_mats_np if t > 0 else np.zeros((1,), np.int64)
    if mat_rows_np.shape[0] == 0:
        mat_rows_np = np.zeros((1, 28), np.float32)
    if accel == "lbvh" or (accel == "auto" and t > DENSE_THRESHOLD):
        raise NotImplementedError(
            "the LBVH accel is not ported yet (ROADMAP.md, Queue 1 item 13); "
            f"this scene has {t} triangles, the dense accel takes up to "
            f"{DENSE_THRESHOLD}")
    if accel not in ("dense", "auto"):
        raise ValueError(f"unknown accel {accel!r}")
    n_chunks = -(-max(t, 1) // intersect.default_pad(t))
    if n_chunks > MAX_CHUNKS:
        raise NotImplementedError(
            f"this scene needs {n_chunks} chunks; scenes above {MAX_CHUNKS} "
            "(the superchunk walk and streaming) are not ported yet "
            "(ROADMAP.md, Queue 2)")
    tris = torch.as_tensor(tris_np, device=device)
    acc = intersect.build_dense(
        tris, aux=torch.as_tensor(mat_ix_padded[:t].astype(np.float32),
                            device=device))
    if t > 0:
        order = acc.perm[:t].long().cpu().numpy()
        row_ix = mat_ix_padded[order]
    else:
        row_ix = mat_ix_padded
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
    with tri_idx in the dense accel's storage (morton) order."""
    return intersect.closest_hit(scene.accel, tmax, origin, d)[:5]


def any_hit(scene: Scene, tmax, origin, d):
    """Shadow query; rays are V3 (3,N)."""
    return intersect.any_hit(scene.accel, tmax, origin, d)


class Interaction(NamedTuple):
    """Per-lane surface interaction."""
    ok: torch.Tensor       # (N,) bool
    t: torch.Tensor        # (N,)
    pos: torch.Tensor      # V3 (3, N)
    normal: torch.Tensor   # V3 (3, N)
    mat: materials.MaterialLanes
    emission_at_wl: torch.Tensor  # (N,) emission at the hero wavelength


def closest_interaction(scene: Scene, tmax, origin, d, wavelen) -> Interaction:
    """closest_hit + material row fetch at the hero wavelength; the
    material id rides the accel's aux column."""
    ok, t, _, pos, normal, aux = intersect.closest_hit(scene.accel, tmax,
                                                        origin, d)
    rows_t = scene.mat_rows[aux.long()].T   # (28, N)
    mat, emission = materials.at_wavelength_rows(rows_t, wavelen)
    return Interaction(ok=ok, t=t, pos=pos, normal=normal, mat=mat,
                       emission_at_wl=emission)
