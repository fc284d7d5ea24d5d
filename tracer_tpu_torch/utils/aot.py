"""Ahead-of-time export of the engine's step (port of
tracer_tpu/utils/aot.py).

The reference's build emits a generated C kernel library, compiled once
and linked by the host apps (SURVEY.md §2.2). The JAX package's analogue
serialises its jitted step with jax.export; this one captures
engine/api.step_core with torch.export, as one program of aten ops, the
pool's loop as torch's while_loop, and the intersection kernels as the
custom ops tracer_tpu_torch::closest_hit and tracer_tpu_torch::any_hit
(ops/intersect_kernel.py), the LBVH walk as
tracer_tpu_torch::lbvh_closest_hit and lbvh_any_hit (ops/bvh.py), a
sorted query's
key and deal as tracer_tpu_torch::lane_key and lane_deal around aten's
stable sort (ops/intersect.py), the shading around the shadow query as
tracer_tpu_torch::shade_prepare and shade_finish (engine/shade.py), the
pool's refill as tracer_tpu_torch::refill (engine/refill.py), the closest
hit's interaction as tracer_tpu_torch::interaction
(engine/interaction.py). A
fresh process loads the artifact and steps a
state with no Python of the renderer: engine/integrator.py,
engine/api.py and the scene build are not
imported.

  export_fn(fn, *example_args) -> bytes   fn captured at these shapes
  load(blob)                              the callable back
  export_step(state) -> bytes             the step, specialised to state
  save_step(state, path), load_step(path)

An artifact is specialised to the shapes and dtypes of its example
arguments, and a step artifact to the state's static fields (width,
height, subsampling, render_mode, transmitter_kind, cam_conf_id) and
accel kind, which it records beside the program. Every tensor of the
state (scene, accel, lights, camera, sky, image) and the four counters
(seed, nonce, n_frames as 0-d int64, mode as 0-d bool) are inputs of the
program, never constants in it, so one artifact steps every state of
the same shapes; a state that differs in a static field, a shape, a
dtype or the device is refused with a ValueError that names it.

An artifact records its device (cpu, cuda:0): export on the device that
will run it. On the card the ops launch the kernels, whose library is
built at first launch (ops/cuda_lib.py, into build/); on the CPU they run
the plain versions.
"""

from __future__ import annotations

import io
import json
from dataclasses import replace

import torch

from tracer_tpu_torch.engine import interaction  # noqa: F401 (the op)
from tracer_tpu_torch.engine import refill  # noqa: F401 (the op)
from tracer_tpu_torch.engine import shade  # noqa: F401 (the ops)
from tracer_tpu_torch.engine.state import EngineState
from tracer_tpu_torch.ops import bvh  # noqa: F401 (the ops)
from tracer_tpu_torch.ops import intersect  # noqa: F401 (the ops)
from tracer_tpu_torch.ops import intersect_kernel  # noqa: F401 (the ops)
from tracer_tpu_torch.utils import checkpoint, profiling

_FORMAT_VERSION = 1
# the archive's file beside the program: what a step artifact takes
_META = "tracer_tpu_torch_step.json"


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, example_args, meta: dict | None) -> bytes:
    with torch.no_grad():
        exported = torch.export.export(_Program(fn), tuple(example_args),
                                       strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def export_fn(fn, *example_args) -> bytes:
    """Serialise fn captured by torch.export at example_args' shapes and
    dtypes. fn is a function of tensors (or tuples, lists and dicts of
    them) that reads no host value; the example tensors are inputs of
    the program, not saved in it."""
    return _export(fn, example_args, None)


def _static(state: EngineState) -> dict:
    """What a step artifact is specialised to besides the shapes."""
    return {**checkpoint._static_fields(state),
            "accel": checkpoint._accel_kind(state.scene.accel),
            "device": str(state.device)}


def _leaves(state: EngineState) -> dict:
    return checkpoint._leaves(state, checkpoint._accel_kind(state.scene.accel))


def _counters(state: EngineState) -> tuple:
    """seed, nonce, n_frames as 0-d int64 and mode as 0-d bool, on the
    state's device (one copy)."""
    c = torch.tensor([state.seed, state.nonce, state.n_frames,
                      int(state.mode)], dtype=torch.int64,
                     device=state.device)
    return c[0], c[1], c[2], c[3] != 0


def _fit_img(state: EngineState) -> EngineState:
    """A state whose image has the shape of its sub_dims, as api.step
    gives it: zeros where it had another."""
    w, h = state.sub_dims
    if tuple(state.img.shape[:2]) != (h, w):
        state = replace(state, img=torch.zeros((h, w, 3),
                                               device=state.device))
    return state


def export_step(state: EngineState) -> bytes:
    """The step artifact: engine/api.step_core, one progressive 1-spp
    frame merged as api.step merges it, specialised to state's static
    fields, accel kind, shapes and device."""
    from tracer_tpu_torch.engine import api

    state = _fit_img(state)
    static = _static(state)
    leaves = _leaves(state)
    names = sorted(leaves)
    # step_core reads the counters from its tensor arguments only
    fixed = {**static, "seed": 0, "nonce": 0, "n_frames": 0, "mode": False}

    def step(seed, nonce, n_frames, mode, *tensors):
        s = checkpoint.assemble(fixed, dict(zip(names, tensors)).__getitem__)
        return api.step_core(s, seed, nonce, n_frames, mode)

    meta = {"version": _FORMAT_VERSION, "static": static,
            "leaves": {k: [list(leaves[k].shape), str(leaves[k].dtype)]
                       for k in names}}
    return _export(step, _counters(state) + tuple(leaves[k] for k in names),
                   meta)


class LoadedStep:
    """A step artifact's program as api.step's twin: takes an EngineState
    (as api.init or checkpoint.load gives it) and returns the state after
    one frame, with python-int counters and the image on the state's
    device."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.static = meta["static"]
        self.leaves = meta["leaves"]

    def check(self, state: EngineState) -> None:
        """Raise ValueError naming the first field, tensor or device in
        which state differs from what the artifact was exported for."""
        got = _static(state)
        for k, want in self.static.items():
            if got[k] != want:
                raise ValueError(f"the step artifact is for {k}={want!r}, "
                                 f"the state has {k}={got[k]!r}")
        leaves = _leaves(state)
        for k, (shape, dtype) in self.leaves.items():
            have = [list(leaves[k].shape), str(leaves[k].dtype)]
            if have != [shape, dtype]:
                raise ValueError(f"the step artifact takes {k} of shape "
                                 f"{tuple(shape)} and {dtype}, the state's "
                                 f"is {tuple(have[0])} and {have[1]}")

    def __call__(self, state: EngineState) -> EngineState:
        state = _fit_img(state)
        self.check(state)
        leaves = _leaves(state)
        with torch.no_grad():
            img, n_frames, nonce = self.program(
                *_counters(state), *(leaves[k] for k in sorted(self.leaves)))
        with profiling.host_read("aot.counters"):
            n_frames, nonce = torch.stack([n_frames, nonce]).tolist()
        return replace(state, img=img, n_frames=n_frames, nonce=nonce)


def load(blob: bytes):
    """The callable of an export_fn or export_step artifact: the program
    runs its aten graph and the registered ops, and never retraces the
    renderer's Python. It imports the op registrations (ops/intersect.py,
    ops/intersect_kernel.py, ops/bvh.py, engine/shade.py,
    engine/refill.py, engine/interaction.py) and the state's structure
    (engine/state.py, utils/checkpoint.py), not engine/integrator.py or
    engine/api.py. A step artifact gives a LoadedStep."""
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra).module()
    meta = json.loads(extra[_META] or "null")
    if meta is None:
        return program
    if meta.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported step artifact version "
                         f"{meta.get('version')!r}")
    return LoadedStep(program, meta)


def save_step(state: EngineState, path: str) -> None:
    with open(path, "wb") as f:
        f.write(export_step(state))


def load_step(path: str) -> LoadedStep:
    with open(path, "rb") as f:
        return load(f.read())
