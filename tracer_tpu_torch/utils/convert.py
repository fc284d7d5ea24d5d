"""Carry an engine state of the JAX package across to this package.

state_from_numpy takes a tracer_tpu EngineState whose array leaves are
already numpy arrays (for example `jax.tree.map(np.asarray, s)`) and
builds the same state, scene and camera here on a given device, without
rebuilding anything: both packages then compute from the very same
scene tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_tpu_torch.engine.state import EngineState
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.models import lights as lights_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import intersect


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def scene_from_numpy(sc, device) -> scene_mod.Scene:
    """A tracer_tpu Scene with numpy leaves -> Scene on `device`."""
    acc = sc.accel
    if not hasattr(acc, "coeffs"):
        raise NotImplementedError(
            "only the dense accel is ported (ROADMAP.md, Queue 1 item 13: "
            "LBVH)")
    accel = intersect.DenseTris(
        coeffs=_t(acc.coeffs, device), tris=_t(acc.tris, device),
        perm=_t(acc.perm, device, torch.int32),
        chunk_bounds=_t(acc.chunk_bounds, device))
    lt = sc.lights
    lights = lights_mod.Lights(
        kind=_t(lt.kind, device, torch.int32), tri=_t(lt.tri, device),
        theta=_t(lt.theta, device), emission=_t(lt.emission, device))
    return scene_mod.Scene(
        tris=_t(sc.tris, device), mat_ix=_t(sc.mat_ix, device, torch.int32),
        mat_rows=_t(sc.mat_rows, device),
        tri_mat=_t(sc.tri_mat, device, torch.int32), lights=lights,
        light_table=_t(sc.light_table, device), accel=accel)


def camera_from_numpy(cam, device) -> cam_mod.Camera:
    conf = cam_mod.CameraConfig(**{
        f: _t(getattr(cam.conf, f), device)
        for f in cam_mod.CameraConfig._fields})
    return cam_mod.Camera(pitch=_t(cam.pitch, device), yaw=_t(cam.yaw, device),
                          origin=_t(cam.origin, device), conf=conf)


def state_from_numpy(tree, device) -> EngineState:
    """A tracer_tpu EngineState with numpy leaves -> EngineState."""
    device = torch.device(device)
    return EngineState(
        width=int(tree.width), height=int(tree.height),
        subsampling=int(tree.subsampling), render_mode=str(tree.render_mode),
        transmitter_kind=str(tree.transmitter_kind),
        cam_conf_id=int(tree.cam_conf_id), seed=int(tree.seed),
        nonce=int(tree.nonce), img=_t(tree.img, device),
        n_frames=int(tree.n_frames), ambience=_t(tree.ambience, device),
        mode=bool(tree.mode), cam=camera_from_numpy(tree.cam, device),
        scene=scene_from_numpy(tree.scene, device))
