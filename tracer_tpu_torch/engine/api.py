"""Public API (port of tracer_tpu/engine/api.py).

  init              build scene + accel + initial state on a device
  step              one progressive 1-spp frame
  render            upsample + pack an ARGB framebuffer
  step_render       step() then render()
  key               runtime UI state machine (host-side)
  resize            swap dimensions, drop accumulation
  sample_n_frames   offline progressive render
  sample_points_n   LiDAR capture: not ported yet, raises

Everything runs eagerly on the device the state was built on; `init`
requires that device explicitly.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from tracer_tpu_torch.engine import integrator, keys
from tracer_tpu_torch.engine.state import EngineState
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.models import sensors
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.ops import spectrum as spec


def init(seed: int, h: int, w: int, cam_conf_id: int,
         tri_geoms, tri_mats, mat_data,
         cam_pitch: float = 0.0, cam_yaw: float = 0.0,
         cam_origin=(0.0, 0.0, 0.0), accel: str = "auto", *,
         device) -> EngineState:
    """Build the scene and the initial engine state on `device`.

    tri_geoms (n,3,3) f32, tri_mats (n,) u32, mat_data (m,28) f32, as
    the loader (tracer_tpu_torch.utils.objloader) returns them."""
    device = torch.device(device)
    conf, render_mode, transmitter_kind = sensors.conf_for_id(cam_conf_id,
                                                              device)
    sc = scene_mod.build_scene(tri_geoms, tri_mats, mat_data, accel=accel,
                               device=device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    cam = cam_mod.Camera(pitch=f32(cam_pitch), yaw=f32(cam_yaw),
                         origin=f32(cam_origin), conf=conf)
    return EngineState(
        width=int(w), height=int(h), subsampling=1,
        render_mode=render_mode, transmitter_kind=transmitter_kind,
        cam_conf_id=int(cam_conf_id), seed=int(seed) & prng.MASK, nonce=0,
        img=torch.zeros((h, w, 3), device=device), n_frames=0,
        ambience=f32(spec.no_sky()), mode=False, cam=cam, scene=sc)


def _fit_img(s: EngineState) -> EngineState:
    w, h = s.sub_dims
    if tuple(s.img.shape[:2]) != (h, w):
        s = replace(s, img=torch.zeros((h, w, 3), device=s.device))
    return s


def _render(s: EngineState, nonce: int, spp: int):
    w, h = s.sub_dims
    return integrator.render_frames(
        s.seed, nonce, s.scene, s.cam, s.ambience, w, h, s.transmitter_kind,
        spp, s.render_mode)


def step(s: EngineState) -> EngineState:
    """Advance one progressive frame: fresh, or EMA-accumulated when the
    mode is on and a frame exists."""
    s = _fit_img(s)
    img_new = _render(s, s.nonce, 1)["img"]
    if s.mode and s.n_frames > 0:
        img = integrator.accumulate_color(s.img, img_new, s.n_frames)
        n_frames = (s.n_frames + 1) & prng.MASK
    else:
        img, n_frames = img_new, 1
    return replace(s, img=img, n_frames=n_frames,
                   nonce=(s.nonce + 1) & prng.MASK)


def render(s: EngineState) -> torch.Tensor:
    """The image as an (h, w) uint32 ARGB framebuffer, nearest-neighbour
    upsampled from the subsampled image."""
    ss = s.subsampling
    ri = torch.arange(s.height, device=s.device) // ss
    ci = torch.arange(s.width, device=s.device) // ss
    up = s.img[ri][:, ci]
    rgb = (torch.clamp(up, 0.0, 1.0) * 255.0).to(torch.int64)
    argb = ((255 << 24) | (rgb[..., 0] << 16) | (rgb[..., 1] << 8)
            | rgb[..., 2])
    return argb.to(torch.uint32)


def step_render(s: EngineState):
    """step() then render(): (new_state, (h, w) uint32 ARGB)."""
    s = step(s)
    return s, render(s)


def resize(h: int, w: int, s: EngineState) -> EngineState:
    """Swap dimensions and drop accumulation (zeroed image)."""
    s = replace(s, width=int(w), height=int(h), mode=False)
    ws, hs = s.sub_dims
    return replace(s, img=torch.zeros((hs, ws, 3), device=s.device))


def _reset(s: EngineState) -> EngineState:
    return replace(s, n_frames=0)


def _cycle_conf(s: EngineState) -> EngineState:
    """'t' cycles sensor configs 0 -> 1 -> 2 -> 0."""
    next_id = {0: 1, 1: 2}.get(s.cam_conf_id, 0)
    conf, render_mode, transmitter_kind = sensors.conf_for_id(next_id,
                                                              s.device)
    s = replace(s, cam_conf_id=next_id, render_mode=render_mode,
                transmitter_kind=transmitter_kind,
                cam=s.cam._replace(conf=conf))
    return _reset(s)


_MOVES = {keys.SDLK_w: (0, 0, 1), keys.SDLK_s: (0, 0, -1),
          keys.SDLK_a: (-1, 0, 0), keys.SDLK_d: (1, 0, 0),
          keys.SDLK_x: (0, 1, 0), keys.SDLK_z: (0, -1, 0)}
_TURNS = {keys.SDLK_UP: (-0.1, 0.0), keys.SDLK_DOWN: (0.1, 0.0),
          keys.SDLK_RIGHT: (0.0, 0.1), keys.SDLK_LEFT: (0.0, -0.1)}


def key(event: int, keycode: int, s: EngineState) -> EngineState:
    """Runtime UI state machine, host-side."""
    if event != keys.KEYDOWN:
        return s
    if keycode in _MOVES:
        return _reset(replace(s, cam=cam_mod.move_camera(s.cam,
                                                         _MOVES[keycode])))
    if keycode in _TURNS:
        dp, dy = _TURNS[keycode]
        return _reset(replace(s, cam=cam_mod.turn_camera(s.cam, dp, dy)))
    if keycode == keys.SDLK_2:
        return _reset(replace(s, subsampling=s.subsampling + 1))
    if keycode == keys.SDLK_1:
        return _reset(replace(s, subsampling=max(1, s.subsampling - 1)))
    if keycode == keys.SDLK_SPACE:
        return _reset(replace(s, mode=not s.mode))
    if keycode == keys.SDLK_n:
        return _reset(replace(s, mode=False))
    if keycode == keys.SDLK_m:
        return replace(s, mode=True)
    conf = s.cam.conf
    if keycode == keys.SDLK_i:  # aperture +0.08 clamp 2 (no accum reset)
        c = conf._replace(aperture=torch.clamp_max(conf.aperture + 0.08, 2.0))
        return replace(s, cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_k:
        c = conf._replace(aperture=torch.clamp_min(conf.aperture - 0.08, 0.0))
        return replace(s, cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_o:  # focal distance x1.14
        c = conf._replace(focal_dist=conf.focal_dist * 1.14)
        return replace(s, cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_l:
        c = conf._replace(
            focal_dist=torch.clamp_min(conf.focal_dist / 1.14, 0.1))
        return replace(s, cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_t:
        return _cycle_conf(s)
    if keycode == keys.SDLK_p:  # toggle sky (no accum reset)
        dark = bool(s.ambience[0, 1] == 0)
        sky = spec.bright_blue_sky() if dark else spec.uniform_spectrum(0.0)
        return replace(s, ambience=torch.as_tensor(sky, device=s.device))
    return s


def sample_n_frames(s: EngineState, n: int) -> torch.Tensor:
    """Offline progressive render over n frames; returns the
    (h_sub, w_sub, 3) f32 image. The EMA chain reduces to the mean of
    frames 2..n (the n_frames=1 merge drops frame 1), so this renders n-1
    samples from nonce+1, or 1 sample from nonce when n <= 1."""
    n = int(n)
    if n <= 1:
        return _render(s, s.nonce, 1)["img"]
    return _render(s, (s.nonce + 1) & prng.MASK, n - 1)["img"]


def sample_points_n(s: EngineState, samples_per_pixel: int):
    raise NotImplementedError(
        "sample_points_n is not ported yet: sensor configs 1 and 2 and the "
        "LiDAR point cloud (ROADMAP.md, Queue 1)")
