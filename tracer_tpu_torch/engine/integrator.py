"""Wavefront path integrator (port of tracer_tpu/engine/integrator.py).

A flat pool of N = w*h lanes advances one bounce per iteration: one
closest-hit query, one NEE+MIS direct-lighting estimate (one any_hit over
2N shadow lanes) and one BSDF sample with unit-weight Russian roulette.
The loop stops after PATH_LEN bounces or when every lane is dead (a host
sync per bounce).

render_frames ports the CONTRACT of the JAX package's render_pooled, not
its schedule: sample s of pixel p draws from make_streams(seed, nonce+s,
p), and the image is the mean over spp of visualize_color. It runs spp
per-frame wavefronts; the pooled lane refill is later work.

Only the colour render of sensor config 0 is ported. The transmitter
fan (configs 1 and 2), distance mode and the LiDAR point outputs raise
NotImplementedError.
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

_NOT_PORTED = ("is not ported yet (ROADMAP.md, Queue 1 item 10: sensor "
               "configs 1 and 2, the transmitter fan and distance mode)")


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


def _require_color(transmitter_kind: str, render_mode: str = "color"):
    if transmitter_kind != cam_mod.TRANSMITTER_NONE:
        raise NotImplementedError(
            f"transmitter {transmitter_kind!r} {_NOT_PORTED}")
    if render_mode != "color":
        raise NotImplementedError(f"render mode {render_mode!r} {_NOT_PORTED}")


def path_trace(state, scene: scene_mod.Scene, origin, d, wavelen, ambience):
    """Trace the lane pool through <= PATH_LEN bounces. Rays are V3 (3, N).
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
    for i in range(PATH_LEN):
        live = int(alive.sum())   # host sync: the early exit
        if live == 0:
            break
        inter = scene_mod.closest_interaction(
            scene, shapes.F32_HIGHEST, o, d, wavelen)
        hit = alive & inter.ok
        miss = alive & ~inter.ok

        wo = -d
        state, direct = direct_mod.direct_radiance(
            state, scene, wo, inter, wavelen, mask=hit)
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
    order; lane p draws from make_streams(seed, nonce, p)."""
    _require_color(transmitter_kind)
    dev = cam.origin.device
    n = w * h
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    jx = (lane % w).to(torch.float32)
    iy = float(h) - (lane // w).to(torch.float32) - 1.0  # y flipped
    state = prng.make_streams(seed, nonce, lane)
    state, wavelen, channel = cam_mod.sample_wavelength(state, cam.conf)
    state, origin, d = cam_mod.sample_ray(state, cam, (w, h), jx, iy)
    state, path, rays = path_trace(state, scene, origin, d, wavelen, ambience)
    return FrameSamples(ray_origin=origin.expand(3, n), ray_dir=d,
                        channel=channel, path=path, rays_traced=rays + n)


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


def accumulate_color(acc, new, n_frames: int):
    """EMA merge with the pre-increment frame count, including the quirk
    that the n_frames=1 merge discards the first frame."""
    nf = float(n_frames)
    return acc * ((nf - 1.0) / nf) + new * (1.0 / nf)


def accumulate_distance(acc, new):
    """Keep the existing pixel when it already has a return."""
    keep = torch.linalg.vector_norm(acc, dim=-1) > 0
    return torch.where(keep[..., None], acc, new)


def render_frames(seed: int, nonce: int, scene: scene_mod.Scene,
                  cam: cam_mod.Camera, ambience, w: int, h: int,
                  transmitter_kind: str, spp: int, render_mode: str):
    """Render spp samples per pixel: the mean over s < spp of
    visualize_color(sample_pixels(seed, nonce + s)).

    Returns {"img": (h, w, 3) f32, "rays_traced": int}, where
    rays_traced counts 3 x live lanes per bounce iteration (render_pooled's
    definition, which bench.py divides by), without primaries."""
    _require_color(transmitter_kind, render_mode)
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    img = torch.zeros((h, w, 3), device=cam.origin.device)
    rays = 0
    for s in range(spp):
        samples = sample_pixels(seed, (nonce + s) & prng.MASK, scene, cam,
                                ambience, w, h, transmitter_kind)
        img += visualize_color(samples, cam.conf.sensor_color, w, h)
        rays += samples.rays_traced - w * h
    return {"img": img * (1.0 / spp), "rays_traced": rays}
