"""Spectral sensor / camera model and ray generation (port of
tracer_tpu/models/camera.py).

A sensor is C spectral channels, each a normal-distribution sensitivity
(mu, sigma) plus a visualization color. One camera sample picks a
channel and draws its hero wavelength by probit from two salted threefry
draws; ray generation is a jittered thin-lens model whose lens sample
reuses the jitter draws, and which hands its INCOMING state on to the
path, as the JAX package and the reference do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import rng as prng

TRANSMITTER_NONE = "none"
TRANSMITTER_FLASH = "flash"
TRANSMITTER_SCANNING = "scanning"


class CameraConfig(NamedTuple):
    """Numeric camera configuration; every field is an f32 tensor."""
    aperture: torch.Tensor        # scalar
    focal_dist: torch.Tensor      # scalar
    offset_radius: torch.Tensor   # scalar
    field_of_view: torch.Tensor   # scalar, radians
    sensor_mu: torch.Tensor       # (C,)
    sensor_sigma: torch.Tensor    # (C,)
    sensor_color: torch.Tensor    # (C, 3) channel visualization colors
    trans_radius: torch.Tensor    # scalar
    trans_theta: torch.Tensor     # scalar, radians
    trans_emission: torch.Tensor  # (6, 2)


class Camera(NamedTuple):
    pitch: torch.Tensor   # scalar
    yaw: torch.Tensor     # scalar
    origin: torch.Tensor  # (3,)
    conf: CameraConfig


def _world_up(like):
    return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                        device=like.device)


def cam_dir(cam: Camera):
    """No cos(pitch) scaling of xz, as the reference."""
    return la.normalize(la.vec3(torch.sin(cam.yaw), torch.sin(cam.pitch),
                                -torch.cos(cam.yaw)))


def cam_right(cam: Camera):
    return la.normalize(la.cross(cam_dir(cam), _world_up(cam.origin)))


def cam_up(cam: Camera):
    return la.normalize(la.cross(cam_right(cam), cam_dir(cam)))


def move_camera(cam: Camera, m) -> Camera:
    """WASD/XZ translation, step 0.1."""
    d = cam_dir(cam)
    forward = la.normalize(la.vec3(d[0], torch.zeros_like(d[1]), d[2]))
    m = torch.as_tensor(m, dtype=torch.float32, device=cam.origin.device)
    origin = (cam.origin
              + (0.1 * m[2]) * forward
              + (0.1 * m[0]) * cam_right(cam)
              + (0.1 * m[1]) * _world_up(cam.origin))
    return cam._replace(origin=origin)


def turn_camera(cam: Camera, dpitch: float, dyaw: float) -> Camera:
    """Arrow-key rotation; pitch clamped to +-pi/2."""
    pitch = torch.clamp(cam.pitch + dpitch, -0.5 * math.pi, 0.5 * math.pi)
    yaw = torch.remainder(cam.yaw + dyaw, 2.0 * math.pi)
    return cam._replace(pitch=pitch, yaw=yaw)


# Salt for the out-of-band channel/wavelength draws (tracer_tpu
# camera._SALT_WAVELENGTH).
_SALT_WAVELENGTH = 0x3C6EF372


def sample_wavelength(state, conf: CameraConfig):
    """Pick a channel uniformly and probit-sample its wavelength. Returns
    (state, wavelen (N,), channel (N,) int32); the main stream advances
    twice so every later draw keeps its position."""
    n_channels = conf.sensor_mu.shape[0]
    b0, b1 = prng.salted_pair(state, _SALT_WAVELENGTH)
    state, _ = prng.next_u32(state)
    state, _ = prng.next_u32(state)
    channel = (b0 % n_channels).to(torch.int32)
    p = (b1 >> 8).to(torch.float32) * prng._UNIT_F
    mu = conf.sensor_mu[channel.long()]
    sigma = conf.sensor_sigma[channel.long()]
    wavelen = mu + sigma * torch.special.ndtri(torch.clamp_min(p, 1e-12))
    return state, wavelen, channel


def sample_ray(state, cam: Camera, wh, jx, iy):
    """Thin-lens jittered primary ray per lane, V3 layout.

    wh: (w, h) python pair; jx/iy: (N,) f32 pixel coords with iy already
    flipped to h - i - 1. Returns (state, origin (3,N), dir (3,N)), where
    state is the INCOMING state, un-advanced.
    """
    conf = cam.conf
    w_f, h_f = float(wh[0]), float(wh[1])
    ratio = w_f / h_f
    state0 = state
    state, (ox, oy) = prng.in_unit_square(state)
    x = (jx + ox * conf.offset_radius) / w_f
    y = (iy + oy * conf.offset_radius) / h_f

    # lens disk from the SAME draws as the jitter
    theta = ox * (2.0 * math.pi / prng.UNIT_SCALE)
    lr = torch.sqrt(oy)
    lx, ly = lr * torch.cos(theta), lr * torch.sin(theta)

    lens_radius = conf.aperture / 2.0
    half_height = torch.tan(conf.field_of_view / 2.0)
    half_width = ratio * half_height
    d = cam_dir(cam)[:, None]       # (3,1)
    u = cam_right(cam)[:, None]
    v = cam_up(cam)[:, None]
    w_vec = -d
    fd = conf.focal_dist
    origin0 = cam.origin[:, None]    # (3,1)
    lower_left = (origin0
                  - (half_width * fd) * u
                  - (half_height * fd) * v
                  - fd * w_vec)
    horizontal = (2.0 * half_width * fd) * u
    vertical = (2.0 * half_height * fd) * v

    lens_offset = (lens_radius * lx) * u + (lens_radius * ly) * v
    origin = origin0 + lens_offset
    target = lower_left + x * horizontal + y * vertical
    return state0, origin, la.v3_normalize(target - origin)
