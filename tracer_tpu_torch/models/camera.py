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
from tracer_tpu_torch.ops import shapes

TRANSMITTER_NONE = "none"
TRANSMITTER_FLASH = "flash"
TRANSMITTER_SCANNING = "scanning"
TRANSMITTER_KINDS = (TRANSMITTER_NONE, TRANSMITTER_FLASH, TRANSMITTER_SCANNING)

TRANSMITTER_SECTORS = 8  # disk fan resolution (camera.fut:113)


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
    return la.v3_const(0.0, 1.0, 0.0, device=like.device)[:, 0]


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
    return draw_wavelength(state, conf.sensor_mu, conf.sensor_sigma)


def draw_wavelength(state, sensor_mu, sensor_sigma):
    """sample_wavelength over the channels' (C,) mu and sigma rows."""
    n_channels = sensor_mu.shape[0]
    b0, b1 = prng.salted_pair(state, _SALT_WAVELENGTH)
    state, _ = prng.next_u32(state)
    state, _ = prng.next_u32(state)
    channel = (b0 % n_channels).to(torch.int32)
    p = (b1 >> 8).to(torch.float32) * prng._UNIT_F
    mu = sensor_mu[channel.long()]
    sigma = sensor_sigma[channel.long()]
    wavelen = mu + sigma * torch.special.ndtri(torch.clamp_min(p, 1e-12))
    return state, wavelen, channel


class RayBasis(NamedTuple):
    """What a primary ray takes of the camera (ray_basis): V3 (3, 1)
    columns, the 0-d lens radius and the jitter's 0-d offset radius."""
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor
    origin: torch.Tensor
    offset_radius: torch.Tensor


def ray_basis(cam: Camera, wh) -> RayBasis:
    """The thin-lens camera's image plane and lens axes for a (w, h)
    python pair: the part of sample_ray that no lane changes."""
    conf = cam.conf
    w_f, h_f = float(wh[0]), float(wh[1])
    ratio = w_f / h_f
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
    return RayBasis(lower_left, horizontal, vertical, u, v, lens_radius,
                    origin0, conf.offset_radius)


def sample_ray(state, cam: Camera, wh, jx, iy):
    """Thin-lens jittered primary ray per lane, V3 layout.

    wh: (w, h) python pair; jx/iy: (N,) f32 pixel coords with iy already
    flipped to h - i - 1. Returns (state, origin (3,N), dir (3,N)), where
    state is the INCOMING state, un-advanced.
    """
    return primary_ray(state, ray_basis(cam, wh), wh, jx, iy)


def primary_ray(state, basis: RayBasis, wh, jx, iy):
    """sample_ray's per-lane part over a ray_basis."""
    w_f, h_f = float(wh[0]), float(wh[1])
    state0 = state
    state, (ox, oy) = prng.in_unit_square(state)
    x = (jx + ox * basis.offset_radius) / w_f
    y = (iy + oy * basis.offset_radius) / h_f

    # lens disk from the SAME draws as the jitter
    theta = ox * (2.0 * math.pi / prng.UNIT_SCALE)
    lr = torch.sqrt(oy)
    lx, ly = lr * torch.cos(theta), lr * torch.sin(theta)

    lens_offset = ((basis.lens_radius * lx) * basis.u
                   + (basis.lens_radius * ly) * basis.v)
    origin = basis.origin + lens_offset
    target = basis.lower_left + x * basis.horizontal + y * basis.vertical
    return state0, origin, la.v3_normalize(target - origin)


def gen_transmitter_sectors(cam: Camera, transmitter_kind: str, ray_dir):
    """The transmitter: an 8-sector disk fan of radius trans_radius at the
    camera origin (tracer_tpu/models/camera.py:185-201). The flash fan
    faces cam_dir and is one (3, 1) fan for every lane; the scanning fan
    faces each lane's own primary direction ray_dir (3, N). Returns a
    list of TRANSMITTER_SECTORS (a, b, c) V3 tuples, or None."""
    if transmitter_kind == TRANSMITTER_NONE:
        return None
    if transmitter_kind == TRANSMITTER_FLASH:
        normal = cam_dir(cam)[:, None]
    else:
        normal = ray_dir
    origin = cam.origin[:, None].expand(normal.shape)
    return shapes.disk_sectors_v(origin, normal, cam.conf.trans_radius,
                                 TRANSMITTER_SECTORS)
