"""Built-in virtual sensor configurations (port of
tracer_tpu/models/sensors.py).

  0 visual        3-channel RGB-ish spectral camera, no transmitter
  1 visual_flash  same sensor + blackbody flash transmitter
  2 lidar         single 1550nm channel + scanning transmitter

All three build their CameraConfig; rendering configs 1 and 2 (the
transmitter fan and the distance mode) is not ported yet and raises.
"""

from __future__ import annotations

import math

import torch

from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.ops import spectrum as spec

CONF_VISUAL = 0
CONF_VISUAL_FLASH = 1
CONF_LIDAR = 2

RENDER_COLOR = "color"
RENDER_DISTANCE = "distance"


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _mkconf(device, aperture, focal_dist, offset_radius, fov_deg, mus,
            sigmas, colors, trans_radius=0.0, trans_theta=0.0,
            trans_emission=None) -> cam_mod.CameraConfig:
    if trans_emission is None:
        trans_emission = spec.uniform_spectrum(0.0)
    return cam_mod.CameraConfig(
        aperture=_f32(aperture, device),
        focal_dist=_f32(focal_dist, device),
        offset_radius=_f32(offset_radius, device),
        field_of_view=_f32(math.radians(fov_deg), device),
        sensor_mu=_f32(mus, device),
        sensor_sigma=_f32(sigmas, device),
        sensor_color=_f32(colors, device),
        trans_radius=_f32(trans_radius, device),
        trans_theta=_f32(trans_theta, device),
        trans_emission=_f32(trans_emission, device),
    )


def visual_conf(device) -> cam_mod.CameraConfig:
    """Canon-400D-like triple-normal sensor."""
    return _mkconf(
        device, aperture=0.0, focal_dist=1.0, offset_radius=1.0,
        fov_deg=80.0, mus=[455.0, 535.0, 610.0], sigmas=[22.0, 32.0, 26.0],
        colors=[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])


def visual_flash_conf(device) -> cam_mod.CameraConfig:
    """Visual sensor + 5500K flash at 1000x intensity."""
    emission = spec.map_intensities(lambda i: i * 1000.0,
                                    spec.blackbody_normalized(5500.0))
    return visual_conf(device)._replace(
        trans_radius=_f32(0.05, device),
        trans_emission=_f32(emission, device))


def lidar_conf(device) -> cam_mod.CameraConfig:
    """1550nm single channel, 3-degree scanning cone."""
    return _mkconf(
        device, aperture=0.0, focal_dist=1.0, offset_radius=0.01,
        fov_deg=90.0, mus=[1550.0], sigmas=[10.0], colors=[[1.0, 0.0, 0.0]],
        trans_radius=0.01, trans_theta=math.radians(3.0),
        trans_emission=spec.uniform_spectrum(1500.0))


def conf_for_id(conf_id: int, device):
    """(config, render_mode, transmitter_kind) for a conf id
    (0 visual, 1 visual+flash, else lidar)."""
    if conf_id == CONF_VISUAL:
        return visual_conf(device), RENDER_COLOR, cam_mod.TRANSMITTER_NONE
    if conf_id == CONF_VISUAL_FLASH:
        return (visual_flash_conf(device), RENDER_COLOR,
                cam_mod.TRANSMITTER_FLASH)
    return lidar_conf(device), RENDER_DISTANCE, cam_mod.TRANSMITTER_SCANNING
