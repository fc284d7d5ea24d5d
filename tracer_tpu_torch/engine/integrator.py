"""Wavefront path integrator (port of tracer_tpu/engine/integrator.py).

A flat pool of N = w*h lanes advances one bounce per iteration: one
closest-hit query, one NEE+MIS direct-lighting estimate (one any_hit over
2N shadow lanes) and one BSDF sample with unit-weight Russian roulette.
The loop stops after PATH_LEN bounces or when every lane is dead (a host
sync per bounce). With a transmitter (sensor configs 1 and 2) the fan
hangs off each lane's primary ray and joins the scene lights.

render_frames ports the CONTRACT of the JAX package's render_pooled, not
its schedule: sample s of pixel p draws from make_streams(seed, nonce+s,
p). It runs spp per-frame wavefronts and merges each frame into (N,)
buffers as it goes; the pooled lane refill is later work. The image is
the mean of visualize_color in colour mode, and in distance mode the hue
of the first sample (smallest s) with a return in the LiDAR window. The
points are the closest windowed return per pixel over all samples, an
exact tie in distance going to the newer sample, as the reference's fold
keeps its new point (lib.fut:49-51).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_tpu_torch.engine import direct as direct_mod
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import materials, shapes
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.ops import spectrum as spec

PATH_LEN = 16  # max path length (integrator.fut:23)

# LiDAR return distance window (lib.fut:40, integrator.fut:153)
LIDAR_MIN_D = 0.5
LIDAR_MAX_D = 10.0

RENDER_MODES = ("color", "distance")


class PathRecords(NamedTuple):
    """Per-bounce records, transposed."""
    distance: torch.Tensor   # (PATH_LEN, N) cumulative distance, +inf dark
    radiance: torch.Tensor   # (PATH_LEN, N)


class FrameSamples(NamedTuple):
    """Everything sample_pixels produces for one 1-spp wavefront."""
    ray_origin: torch.Tensor  # (3, N) primary ray
    ray_dir: torch.Tensor     # (3, N)
    channel: torch.Tensor     # (N,) int32 sensor channel of the hero sample
    path: PathRecords
    rays_traced: int          # trace queries, primaries included


def _check_modes(transmitter_kind: str, render_mode: str = "color"):
    if transmitter_kind not in cam_mod.TRANSMITTER_KINDS:
        raise ValueError(f"transmitter_kind must be one of "
                         f"{cam_mod.TRANSMITTER_KINDS}, got {transmitter_kind!r}")
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got "
                         f"{render_mode!r}")


def path_trace(state, scene: scene_mod.Scene, origin, d, wavelen, ambience,
               trans: direct_mod.Transmitter | None = None):
    """Trace the lane pool through <= PATH_LEN bounces
    (tracer_tpu/engine/integrator.py:63-142). Rays are V3 (3, N); trans
    is the sensor's transmitter (direct.transmitter), or None.
    Returns (rng_state, PathRecords, rays_traced), with rays_traced
    3 x live lanes per bounce (one closest + two shadow queries)."""
    n = d.shape[-1]
    dev = d.device
    ambient = spec.lookup_table(wavelen, ambience.to(dev))
    o = origin.expand(3, n)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    cum_dist = torch.zeros((n,), device=dev)
    dist = torch.full((PATH_LEN, n), float("inf"), device=dev)
    rad = torch.zeros((PATH_LEN, n), device=dev)
    rays = 0
    far = torch.as_tensor(shapes.F32_HIGHEST, dtype=torch.float32, device=dev)
    for i in range(PATH_LEN):
        live = int(alive.sum())   # host sync: the early exit
        if live == 0:
            break
        # a dead lane queries at tmax 0: it hits nothing and the kernel
        # leaves it out of its walk; every use of inter below is masked
        inter = scene_mod.closest_interaction(
            scene, torch.where(alive, far, 0.0), o, d, wavelen)
        hit = alive & inter.ok
        miss = alive & ~inter.ok

        wo = -d
        state, direct = direct_mod.direct_radiance(
            state, scene, wo, inter, wavelen, trans, mask=hit)
        radiance = direct + inter.emission_at_wl if i == 0 else direct
        cum_dist = torch.where(hit, cum_dist + inter.t, cum_dist)
        dist[i] = torch.where(hit, cum_dist, float("inf"))
        rad[i] = torch.where(hit, radiance, torch.where(miss, ambient, 0.0))

        state, wi, bsdf, pdf_val, pdf_kind = materials.sample_dir(
            state, wo, inter.normal, inter.mat)
        pdf = torch.where(pdf_kind == materials.PDF_DELTA, 1.0,
                          torch.where(pdf_kind == materials.PDF_NONZERO,
                                      pdf_val, 0.0))
        cos_falloff = torch.abs(la.v3_dot(inter.normal, wi))
        p_terminate = 1.0 - bsdf * cos_falloff / pdf
        state, u = prng.next_unit(state)
        alive_next = hit & (pdf != 0) & ~(u < p_terminate)

        o_new, d_new = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
        o = torch.where(alive_next, o_new, o)
        d = torch.where(alive_next, d_new, d)
        alive = alive_next
        rays += 3 * live
    return state, PathRecords(distance=dist, radiance=rad), rays


def sample_pixels(seed: int, nonce: int, scene: scene_mod.Scene,
                  cam: cam_mod.Camera, ambience, w: int, h: int,
                  transmitter_kind: str) -> FrameSamples:
    """One 1-spp wavefront over a w x h grid, N = w*h lanes in row-major
    order; lane p draws from make_streams(seed, nonce, p). The
    transmitter fan hangs off each lane's primary ray
    (tracer_tpu/engine/integrator.py:145-185)."""
    _check_modes(transmitter_kind)
    dev = cam.origin.device
    n = w * h
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    jx = (lane % w).to(torch.float32)
    iy = float(h) - (lane // w).to(torch.float32) - 1.0  # y flipped
    state = prng.make_streams(seed, nonce, lane)
    state, wavelen, channel = cam_mod.sample_wavelength(state, cam.conf)
    state, origin, d = cam_mod.sample_ray(state, cam, (w, h), jx, iy)
    state, path, rays = path_trace(
        state, scene, origin, d, wavelen, ambience,
        direct_mod.transmitter(cam, transmitter_kind, d))
    return FrameSamples(ray_origin=origin.expand(3, n), ray_dir=d,
                        channel=channel, path=path, rays_traced=rays + n)


# ---------------------------------------------------------------------------
# Visualization (tracer_tpu/engine/integrator.py:990-1040)

def hue_to_rgb(hhue):
    """HSV->RGB at full saturation/value: (N,) -> (3, N)."""
    hp = hhue * 6.0
    x = 1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0)
    k = torch.floor(hp).to(torch.int32)
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    sextants = [la.v3(one, x, zero), la.v3(x, one, zero),
                la.v3(zero, one, x), la.v3(zero, x, one),
                la.v3(x, zero, one)]
    rgb = la.v3(one, zero, x)
    for kk, val in enumerate(sextants):
        rgb = torch.where(k == kk, val, rgb)
    return rgb


def visualize_color(samples: FrameSamples, channel_colors, w: int, h: int):
    """Per-bounce radiance summed and routed to the sample's channel
    color, scaled by the channel count. Returns (h, w, 3)."""
    n_channels = channel_colors.shape[0]
    intensity = torch.sum(samples.path.radiance, dim=0)   # (N,)
    color = channel_colors[samples.channel.long()].T      # (3, N)
    img = (intensity * color) * float(n_channels)
    return la.v3_to_array(img).reshape(h, w, 3)


def _windowed_min(path: PathRecords):
    """Per lane, the least distance of a record with radiance > 0 inside
    the LiDAR window; +inf without one."""
    d = path.distance
    valid = (path.radiance > 0) & (d > LIDAR_MIN_D) & (d < LIDAR_MAX_D)
    return torch.where(valid, d, float("inf")).amin(dim=0)


def _distance_rgb(dmin):
    """Hue of a windowed distance (N,), black where it is +inf: (3, N)."""
    has = torch.isfinite(dmin)
    hue = 0.85 * (dmin - LIDAR_MIN_D) / (LIDAR_MAX_D - LIDAR_MIN_D)
    rgb = hue_to_rgb(torch.where(has, hue, 0.0))
    return torch.where(has, rgb, 0.0)


def visualize_distance(samples: FrameSamples, w: int, h: int):
    """Closest valid LiDAR return mapped to hue. Returns (h, w, 3)."""
    img = _distance_rgb(_windowed_min(samples.path))
    return la.v3_to_array(img).reshape(h, w, 3)


def visualize(samples: FrameSamples, render_mode: str, channel_colors,
              w: int, h: int):
    if render_mode == "distance":
        return visualize_distance(samples, w, h)
    return visualize_color(samples, channel_colors, w, h)


# ---------------------------------------------------------------------------
# Frame accumulation (tracer_tpu/engine/integrator.py:1046-1058)

def accumulate_color(acc, new, n_frames: int):
    """EMA merge with the pre-increment frame count, including the quirk
    that the n_frames=1 merge discards the first frame."""
    nf = float(n_frames)
    return acc * ((nf - 1.0) / nf) + new * (1.0 / nf)


def accumulate_distance(acc, new):
    """Keep the existing pixel when it already has a return."""
    keep = torch.linalg.vector_norm(acc, dim=-1) > 0
    return torch.where(keep[..., None], acc, new)


# ---------------------------------------------------------------------------
# LiDAR point clouds (tracer_tpu/engine/integrator.py:1064-1105)

class CloudPoints(NamedTuple):
    pos: torch.Tensor        # (3, PATH_LEN, N)
    distance: torch.Tensor   # (PATH_LEN, N)
    intensity: torch.Tensor  # (PATH_LEN, N)


def to_cloud_points(samples: FrameSamples) -> CloudPoints:
    """Positions along the straight primary ray at each record's path
    distance (tracer_tpu/engine/integrator.py:1070-1078)."""
    dists = samples.path.distance
    safe_d = torch.where(torch.isfinite(dists), dists, 0.0)
    pos = (samples.ray_origin[:, None, :]
           + safe_d[None] * samples.ray_dir[:, None, :])
    return CloudPoints(pos=pos, distance=dists,
                       intensity=samples.path.radiance)


def closest_return(points: CloudPoints, spp_factor: float):
    """Scale intensity by 1/spp, keep the records inside the LiDAR window
    with intensity > 0, and return each lane's least-distance one, the
    first bounce on a tie (tracer_tpu/engine/integrator.py:1081-1105,
    lib.fut:40-47). Returns (pos (3, N),
    distance (N,), intensity (N,)); a lane without a return gets
    pos (-1, -1, -1), distance +inf and intensity 0."""
    inten = points.intensity * spp_factor
    valid = ((inten > 0) & (points.distance > LIDAR_MIN_D)
             & (points.distance < LIDAR_MAX_D))
    dist = torch.where(valid, points.distance, float("inf"))
    best_d = dist.amin(dim=0)
    has = torch.isfinite(best_d)
    # argmax of a 0/1 mask is its first 1 (torch.argmax picks the first
    # of equal maxima)
    k = (dist == best_d).to(torch.uint8).argmax(dim=0)
    pos = torch.gather(points.pos, 1,
                       k[None, None].expand(3, 1, -1)).squeeze(1)
    best_i = torch.gather(inten, 0, k[None]).squeeze(0)
    return (torch.where(has, pos, -1.0), best_d,
            torch.where(has, best_i, 0.0))


def merge_returns(best, new):
    """Merge a later sample's closest returns `new` into the running
    `best`, both (pos (3, N), distance (N,), intensity (N,)): the strict
    minimum in distance, an exact tie going to the newer sample, as the
    reference's fold `if p1.d < p2.d then p1 else p2` keeps p2, the new
    point (lib.fut:49-51; render_pooled's merge,
    tracer_tpu/engine/integrator.py:729-740, :900-909); a lane of `new`
    without a return never wins."""
    newer = torch.isfinite(new[1]) & (new[1] <= best[1])
    return tuple(torch.where(newer, b, a) for a, b in zip(best, new))


# ---------------------------------------------------------------------------
# Multi-sample rendering

def render_frames(seed: int, nonce: int, scene: scene_mod.Scene,
                  cam: cam_mod.Camera, ambience, w: int, h: int,
                  transmitter_kind: str, spp: int, render_mode: str,
                  with_points: bool = False):
    """Render spp samples per pixel, sample s from sample_pixels(seed,
    nonce + s), with render_pooled's contract
    (tracer_tpu/engine/integrator.py:436-984).

    Returns {"img": (h, w, 3) f32, "rays_traced": int} and, with
    with_points, "points": (pos (3, N), distance (N,), intensity (N,)),
    the closest return per pixel (closest_return of every frame, merged
    in sample order by merge_returns). rays_traced counts 3 x live lanes per bounce iteration
    (render_pooled's definition, which bench.py divides by), without
    primaries. Only (N,) buffers live across frames."""
    _check_modes(transmitter_kind, render_mode)
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    dev = cam.origin.device
    n = w * h
    color = render_mode == "color"
    img = torch.zeros((h, w, 3), device=dev) if color else None
    first_d = None if color else torch.full((n,), float("inf"), device=dev)
    if with_points:
        best = (torch.full((3, n), -1.0, device=dev),
                torch.full((n,), float("inf"), device=dev),
                torch.zeros((n,), device=dev))
    rays = 0
    for s in range(spp):
        samples = sample_pixels(seed, (nonce + s) & prng.MASK, scene, cam,
                                ambience, w, h, transmitter_kind)
        rays += samples.rays_traced - n
        if color:
            img += visualize_color(samples, cam.conf.sensor_color, w, h)
        else:
            # the first sample with a windowed return sets the hue
            first_d = torch.where(torch.isfinite(first_d), first_d,
                                  _windowed_min(samples.path))
        if with_points:
            best = merge_returns(best, closest_return(
                to_cloud_points(samples), 1.0 / spp))
    if color:
        img = img * (1.0 / spp)
    else:
        img = la.v3_to_array(_distance_rgb(first_d)).reshape(h, w, 3)
    out = {"img": img, "rays_traced": rays}
    if with_points:
        out["points"] = best
    return out
