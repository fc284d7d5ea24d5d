"""Engine-state checkpoint / resume (port of
tracer_tpu/utils/checkpoint.py).

A checkpoint is STANDALONE: the structure of the state (every static
field, the camera, the scene with its lights and its accel, dense or
LBVH) is written as JSON beside the tensors, so `load(path)` restores in
a fresh process with no template and without rebuilding the scene;
progressive accumulation (img + n_frames + nonce) resumes exactly where
it stopped.

The file is an .npz of plain arrays. Nothing is pickled on the way out,
and the way in reads with allow_pickle=False, so a file that carries an
object (and with it code) is refused.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tracer_tpu_torch.engine.state import EngineState
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.models import lights as lights_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import bvh as bvh_mod
from tracer_tpu_torch.ops import intersect

_FORMAT_VERSION = 1

# what load() checks against the restored state and against a template
_STATIC_FIELDS = ("width", "height", "subsampling", "render_mode",
                  "transmitter_kind", "cam_conf_id")
_COUNTERS = ("seed", "nonce", "n_frames", "mode")
_CAMERA_FIELDS = ("pitch", "yaw", "origin")
_LIGHT_FIELDS = ("kind", "tri", "theta", "emission")
_SCENE_FIELDS = ("tris", "mat_ix", "mat_rows", "tri_mat", "light_table")
_ACCELS = {
    "dense": (intersect.DenseTris,
              ("coeffs", "tris", "perm", "chunk_bounds")),
    "lbvh": (bvh_mod.LBVH, ("node_min", "node_max", "left", "right",
                            "parent", "tris", "perm")),
}


def _static_fields(state: EngineState) -> dict:
    return {k: getattr(state, k) for k in _STATIC_FIELDS}


def _accel_kind(accel) -> str:
    for kind, (cls, _) in _ACCELS.items():
        if isinstance(accel, cls):
            return kind
    raise TypeError(f"cannot checkpoint accel {type(accel).__name__}")


def _leaves(state: EngineState, accel_kind: str) -> dict:
    """Every tensor of the state under a dotted name."""
    sc = state.scene
    out = {"img": state.img, "ambience": state.ambience}
    out.update({f"cam.{f}": getattr(state.cam, f) for f in _CAMERA_FIELDS})
    out.update({f"cam.conf.{f}": getattr(state.cam.conf, f)
                for f in cam_mod.CameraConfig._fields})
    out.update({f"scene.{f}": getattr(sc, f) for f in _SCENE_FIELDS})
    out.update({f"scene.lights.{f}": getattr(sc.lights, f)
                for f in _LIGHT_FIELDS})
    out.update({f"scene.accel.{f}": getattr(sc.accel, f)
                for f in _ACCELS[accel_kind][1]})
    return out


def save(path: str, state: EngineState) -> None:
    """Write the full engine state (scene included) to an .npz file."""
    accel_kind = _accel_kind(state.scene.accel)
    leaves = _leaves(state, accel_kind)
    static = {"version": _FORMAT_VERSION, **_static_fields(state),
              **{k: getattr(state, k) for k in _COUNTERS},
              "accel": accel_kind, "leaves": sorted(leaves)}
    np.savez_compressed(
        path,
        __static__=np.frombuffer(json.dumps(static).encode(), dtype=np.uint8),
        **{k: v.detach().cpu().numpy() for k, v in leaves.items()})


def assemble(static: dict, leaf) -> EngineState:
    """The state whose fields static (the static fields, the counters
    and "accel") gives and whose tensor under each dotted name of _leaves
    is leaf(name)."""
    def group(prefix, fields):
        return {f: leaf(f"{prefix}{f}") for f in fields}

    accel_cls, accel_fields = _ACCELS[static["accel"]]
    lights = lights_mod.Lights(**group("scene.lights.", _LIGHT_FIELDS))
    scene = scene_mod.Scene(**group("scene.", _SCENE_FIELDS), lights=lights,
                            accel=accel_cls(**group("scene.accel.",
                                                    accel_fields)))
    cam = cam_mod.Camera(
        **group("cam.", _CAMERA_FIELDS),
        conf=cam_mod.CameraConfig(**group("cam.conf.",
                                          cam_mod.CameraConfig._fields)))
    return EngineState(**{k: static[k] for k in _STATIC_FIELDS + _COUNTERS},
                       img=leaf("img"), ambience=leaf("ambience"), cam=cam,
                       scene=scene)


def load(path: str, template: EngineState | None = None, *,
         device="cuda") -> EngineState:
    """Restore a state saved by save(), on `device`. A template's static
    configuration is checked against the checkpoint's."""
    device = torch.device(device)
    data = np.load(path, allow_pickle=False)
    static = json.loads(bytes(data["__static__"]).decode())
    if static.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {static}")
    if static["accel"] not in _ACCELS:
        raise ValueError(f"unknown accel {static['accel']!r} in checkpoint")

    state = assemble(static, lambda k: torch.as_tensor(data[k], device=device))
    if template is not None:
        for k, v in _static_fields(template).items():
            if v != static[k]:
                raise ValueError(
                    f"checkpoint static field {k}={static[k]} does not "
                    f"match template {v}")
    return state
