"""Engine state (port of tracer_tpu/engine/state.py) as a plain
dataclass. The counters are python ints (u32 words), the image and the
sky spectrum are tensors on the scene's device."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.models import scene as scene_mod


@dataclass
class EngineState:
    width: int
    height: int
    subsampling: int
    render_mode: str        # "color" | "distance"
    transmitter_kind: str   # camera.TRANSMITTER_*
    cam_conf_id: int
    seed: int               # u32
    nonce: int              # u32, per-frame stream counter
    img: torch.Tensor       # (h_sub, w_sub, 3) f32 accumulated frame
    n_frames: int           # u32
    ambience: torch.Tensor  # (6, 2) sky spectrum
    mode: bool              # progressive accumulation on
    cam: cam_mod.Camera
    scene: scene_mod.Scene

    @property
    def sub_dims(self) -> tuple[int, int]:
        """(w, h) at the current subsampling."""
        ss = self.subsampling
        return (-(-self.width // ss), -(-self.height // ss))

    @property
    def device(self) -> torch.device:
        return self.img.device
