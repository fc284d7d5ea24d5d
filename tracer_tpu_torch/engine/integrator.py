"""Wavefront path integrator (port of tracer_tpu/engine/integrator.py).

One bounce of a lane (_bounce): one closest-hit query, one NEE+MIS
direct-lighting estimate (one any_hit over 2N shadow lanes) and one BSDF
sample with unit-weight Russian roulette. With a transmitter (sensor
configs 1 and 2) the fan hangs off each lane's primary ray and joins the
scene lights. Two schedules run that body:

render_pooled, which the API calls, is the JAX package's render_pooled
by its CONTRACT, not its XLA devices: a pool of P lanes in which a lane
whose path has ended takes the next (sample, pixel) work item, so no
lane idles through a bounce tail. Work items are handed out by a prefix sum
over the idle lanes against a counter on the device; every (sample,
pixel) writes a result slot of its own and the slots are merged in
sample order, so the result does not depend on the order in which lanes
finish and two runs give the same bits.

render_frames is the plain per-frame version it is held against: spp
whole wavefronts (sample_pixels -> path_trace), each a flat pool of N =
w*h lanes that stops after PATH_LEN bounces or when every lane is dead
(a host sync per bounce), merged into (N,) buffers as it goes.

In both, sample s of pixel p draws from make_streams(seed, nonce+s, p).
The image is the mean of visualize_color in colour mode, and in distance
mode the hue of the first sample (smallest s) with a return in the LiDAR
window. The points are the closest windowed return per pixel over all
samples, an exact tie in distance going to the newer sample, as the
reference's fold keeps its new point (lib.fut:49-51).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_tpu_torch.engine import direct as direct_mod
from tracer_tpu_torch.engine import refill as refill_mod
from tracer_tpu_torch.engine import shade
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import intersect
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import loop
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.ops import spectrum as spec
from tracer_tpu_torch.utils import profiling

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


class Bounce(NamedTuple):
    """What one bounce of the lane pool produces (_bounce)."""
    state: torch.Tensor      # (N,) rng state after the bounce
    hit: torch.Tensor        # (N,) bool: alive and hit a surface
    radiance: torch.Tensor   # (N,) this bounce's record, 0 on idle lanes
    cum_dist: torch.Tensor   # (N,) path distance so far
    rec_dist: torch.Tensor   # (N,) cum_dist on a hit, +inf otherwise
    scatters: torch.Tensor   # (N,) bool: the BSDF sample survived roulette
    o: torch.Tensor          # (3, N) next ray of a scattering lane
    d: torch.Tensor          # (3, N)


def _bounce(state, scene: scene_mod.Scene, alive, first, o, d, wavelen,
            ambient, cum_dist, trans) -> Bounce:
    """One bounce of every lane: the closest hit, NEE + MIS direct light,
    one BSDF sample and unit-weight Russian roulette
    (tracer_tpu/engine/integrator.py:85-118, :757-845). alive (N,) bool;
    first says where a hit adds the surface's own emission (a lane's
    bounce 0): a python bool for all lanes, or (N,) bool. A lane that is
    not alive queries at tmax 0: it hits nothing and the kernel leaves it
    out of its walk; every use of its interaction is masked. The shading
    around the shadow query is engine/shade.py's two ops (the kernels on
    the card). Spans bounce.closest, bounce.shade (shade_prepare),
    bounce.shadow (the any-hit query) and bounce.finish (utils/profiling)."""
    far = torch.finfo(torch.float32).max   # shapes.F32_HIGHEST in f32
    with profiling.span("bounce.closest"):
        inter = scene_mod.closest_interaction(
            scene, torch.where(alive, far, 0.0), o, d, wavelen)
    with profiling.span("bounce.shade"):
        prep = shade.prepare(state, alive, inter, d, wavelen, cum_dist,
                             scene.light_table, trans)
    with profiling.span("bounce.shadow"):
        sh = prep.shadow
        if prep.n_lights:
            blocked = scene_mod.any_hit(scene, sh.tmax, sh.origin, sh.dir)
        else:   # no light to sample: no shadow ray to trace
            blocked = torch.zeros_like(sh.tmax, dtype=torch.bool)
    with profiling.span("bounce.finish"):
        radiance = shade.finish(blocked, prep, inter.emission_at_wl, ambient,
                                first)
    return Bounce(prep.state, prep.hit, radiance, prep.cum_dist,
                  prep.rec_dist, prep.scatters, prep.o, prep.d)


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
    for i in range(PATH_LEN):
        live = int(alive.sum())   # host sync: the early exit
        if live == 0:
            break
        b = _bounce(state, scene, alive, i == 0, o, d, wavelen, ambient,
                    cum_dist, trans)
        state, cum_dist = b.state, b.cum_dist
        dist[i] = b.rec_dist
        rad[i] = b.radiance
        o = torch.where(b.scatters, b.o, o)
        d = torch.where(b.scatters, b.d, d)
        alive = b.scatters
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

def accumulate_color(acc, new, n_frames):
    """EMA merge with the pre-increment frame count, including the quirk
    that the n_frames=1 merge discards the first frame. n_frames is a
    python int, whose weights are float64 quotients rounded once to f32,
    or a 0-d tensor, whose weights are f32 quotients as the JAX package
    computes them: the same f32 for every n_frames < 2^24."""
    nf = (n_frames.to(torch.float32) if isinstance(n_frames, torch.Tensor)
          else float(n_frames))
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


# ---------------------------------------------------------------------------
# The pooled render: lane refill (tracer_tpu/engine/integrator.py:436-984)

# Most lanes of the pool, by what the closest-hit query costs: a scene
# whose triangles stay resident in shared memory (K1/K3) and one that is
# streamed chunk by chunk (K2/K4). The loop was bound by the host's
# dispatch of ~2,400-3,200 eager ops per iteration whatever P, so more
# lanes mean fewer iterations until the device's time per iteration
# passes the host's and the drain tail (<= PATH_LEN iterations) is most
# of the run. (The shading kernels of engine/shade.py have since cut the
# eager ops to about a third; the sizes below were measured before.)
# Measured on an NVIDIA H100 at 700 W
# (python -m tracer_tpu_torch.utils.pool_timing, seconds of two runs each,
# at P = n/4 .. 16n of n pixels): 512x512 x 16 spp Cornell 3.59-3.61,
# 1.77-1.82, 1.06-1.68 (P = n), 0.78-1.40, 0.59-1.17, 0.70-0.90 (8n =
# 2,097,152), 1.16-1.19; the 640x480 x 100 spp capture 27.2-28.6,
# 13.1-14.7, 7.7-10.7, 3.8-5.0, 2.0-3.1, 1.84-1.99 (8n), 2.34-2.35;
# cornell-sub6 (streamed) 6.2-6.9, 3.2-3.6, 2.0-2.4, 1.67-2.11 (2n =
# 524,288), 1.72-2.03, 2.10-2.14, 3.65. One sample per pixel (`step`) at
# 800x600 and 512x512: P = n/2 and n within their spread, n/4 slower; the
# cap leaves P = n there.
POOL_LANES_RESIDENT = 2_097_152
POOL_LANES_STREAMED = 524_288
# Per-(sample, pixel) result slots held at once; a render that needs more
# runs in rounds of whole samples, merged in sample order.
STORE_BYTES = 2 << 30


def _scene_t_pad(scene: scene_mod.Scene) -> int:
    """Padded triangle count of the dense accel, the triangle count of
    any other: what one closest-hit query scans at most."""
    if isinstance(scene.accel, intersect.DenseTris):
        return int(scene.accel.coeffs.shape[1])
    return int(scene.tris.shape[0])


def _pool_size(n: int, spp: int, t_pad: int) -> int:
    """Lanes P of the pool for n pixels x spp samples over a scene of
    t_pad padded triangles: every work item at once, up to the cap of
    the scene's kind (the constants above). P need not divide n: work
    item j is sample j // n of pixel j % n whatever lane takes it."""
    cap = (POOL_LANES_STREAMED if ik.streamed_variant(t_pad)
           else POOL_LANES_RESIDENT)
    return max(1, min(n * spp, cap))


# The pool's carry between iterations, in order: the lane state, the
# points' lane state with_points, then the result stores a render keeps
# (_store_names).
_LANES = ("it", "next_item", "active", "item", "state", "bounce", "o", "d",
          "po", "pd", "wavelen", "chan", "cum_dist", "sample_rad",
          "sample_min_d", "live")
_POINT_LANES = ("sample_pos", "sample_int")


def _store_names(color: bool, with_points: bool) -> tuple:
    return ((("rad", "chan8") if color else ())
            + (("mind",) if not color or with_points else ())
            + (("pos", "int") if with_points else ()))


def _pool_round(seed, nonce, scene, cam, ambience, w, h, transmitter_kind,
                spp, row0, full_h, pool, color, with_points, spp_factor):
    """Run `spp` samples of every pixel through a pool of `pool` lanes.
    Returns (store, live): store maps a name to the (spp, n) results of
    every (sample, pixel) slot ("pos": (3, spp, n)), live is the
    (max_iters,) int64 count of active lanes per iteration, zeros past
    the end.

    The iteration (body) works on a tuple of tensors of fixed shapes and
    reads no host value; ops/loop.run drives it. Eagerly the exit flag
    is read on the host only once every work item may have been handed
    out (from full_iters on); traced (utils/aot.py) it is torch's
    while_loop with cond (it < full_iters) | any lane active | items
    left, under it < max_iters, which holds wherever the eager loop
    does not read it: the two give the same bits."""
    dev = cam.origin.device
    n = w * h
    total = n * spp
    ambience = ambience.to(dev)
    flash = (direct_mod.transmitter(cam, transmitter_kind, None)
             if transmitter_kind == cam_mod.TRANSMITTER_FLASH else None)
    cam_op = refill_mod.camera_operand(cam, w, full_h)
    seed_t = refill_mod.device_scalar(seed, dev)
    nonce_t = refill_mod.device_scalar(nonce, dev)
    full_iters = -(-total // pool)     # no exit before every item is out
    max_iters = full_iters * PATH_LEN + PATH_LEN + 4

    # one slot per work item and a last one that takes the writes of the
    # lanes that did not end: no two lanes share a real slot, so the
    # stores hold the same values whatever order the lanes finish in
    stores = _store_names(color, with_points)
    names = _LANES + (_POINT_LANES if with_points else ()) + stores
    f32, i64, inf = torch.float32, torch.int64, float("inf")
    lane, v3, slots = (pool,), (3, pool), (total + 1,)
    first = {   # name: (shape, value, dtype) before the first iteration
        "it": ((), 0, i64), "next_item": ((), 0, i64),
        "active": (lane, False, torch.bool), "item": (lane, total, i64),
        "state": (lane, 0, i64), "bounce": (lane, 0, torch.int32),
        "o": (v3, 0.0, f32), "d": (v3, 0.0, f32), "po": (v3, 0.0, f32),
        "pd": (v3, 0.0, f32), "wavelen": (lane, 0.0, f32),
        "chan": (lane, 0, torch.int32), "cum_dist": (lane, 0.0, f32),
        "sample_rad": (lane, 0.0, f32), "sample_min_d": (lane, inf, f32),
        "live": ((max_iters,), 0, i64), "sample_pos": (v3, 0.0, f32),
        "sample_int": (lane, 0.0, f32), "rad": (slots, 0.0, f32),
        "chan8": (slots, 0, torch.int8), "mind": (slots, inf, f32),
        "pos": ((3, total + 1), 0.0, f32), "int": (slots, 0.0, f32)}
    init = tuple(torch.full(first[k][0], first[k][1], dtype=first[k][2],
                            device=dev) for k in names)

    def cond(*carry):
        c = dict(zip(names, carry))
        return (c["it"] < max_iters) & (
            (c["it"] < full_iters) | c["active"].any()
            | (c["next_item"] < total))

    def body(*carry):
        c = dict(zip(names, carry))
        with profiling.span("bounce.refill"):
            # the r-th idle lane takes item next_item + r, and a starting
            # lane its camera sample (engine/refill.py, K13 on the card)
            rank = torch.cumsum(~c["active"], 0)
            lanes, sectors = refill_mod.refill(
                rank, c, cam_op, seed_t, nonce_t, total, n, w, full_h, row0,
                transmitter_kind)
            (next_item, active, item, state, bounce, o, d, po, pd, wavelen,
             chan, cum_dist, sample_rad, sample_min_d) = (
                 lanes[k] for k in refill_mod.LANES)
            live = c["live"].index_copy(0, c["it"].reshape(1),
                                        active.sum().reshape(1))
            # the transmitter fan hangs off the PRIMARY ray
            trans = (flash if sectors is None else direct_mod.as_transmitter(
                cam, transmitter_kind, sectors))
        b = _bounce(state, scene, active, bounce == 0, o, d, wavelen,
                    spec.lookup_table(wavelen, ambience), cum_dist, trans)
        with profiling.span("bounce.store"):
            sample_rad = sample_rad + b.radiance
            closer = ((b.radiance > 0) & (b.rec_dist > LIDAR_MIN_D)
                      & (b.rec_dist < LIDAR_MAX_D) & active
                      & (b.rec_dist < sample_min_d))
            sample_min_d = torch.where(closer, b.rec_dist, sample_min_d)
            out = {"it": c["it"] + 1, "next_item": next_item, "item": item,
                   "state": b.state, "wavelen": wavelen, "chan": chan,
                   "po": po, "pd": pd, "cum_dist": b.cum_dist,
                   "sample_rad": sample_rad, "sample_min_d": sample_min_d,
                   "live": live}
            if with_points:
                out["sample_pos"] = torch.where(
                    closer, po + b.rec_dist * pd, c["sample_pos"])
                out["sample_int"] = torch.where(
                    closer, b.radiance * spp_factor, c["sample_int"])
            continues = b.scatters & (bounce + 1 < PATH_LEN)
            ended = active & ~continues
            out["o"] = torch.where(continues, b.o, o)
            out["d"] = torch.where(continues, b.d, d)
            out["bounce"] = bounce + 1
            out["active"] = continues

            # written out of place: a traced step may not change its
            # inputs
            slot = torch.where(ended, item, total)
            values = {"rad": sample_rad, "chan8": chan.to(torch.int8),
                      "mind": sample_min_d, "pos": out.get("sample_pos"),
                      "int": out.get("sample_int")}
            for k in stores:
                out[k] = c[k].index_copy(c[k].dim() - 1, slot, values[k])
        return tuple(out[k] for k in names)

    carry = dict(zip(names, loop.run(cond, body, init, max_iters,
                                     name="pool", check_from=full_iters)))
    out = {k: carry[k][..., :total].reshape(*carry[k].shape[:-1], spp, n)
           for k in stores}
    if color:
        out["chan"] = out.pop("chan8")
    return out, carry["live"]


def render_pooled(seed: int, nonce: int, scene: scene_mod.Scene,
                  cam: cam_mod.Camera, ambience, w: int, h: int,
                  transmitter_kind: str, spp: int, render_mode: str,
                  row0: int = 0, full_h: int | None = None,
                  with_points: bool = False):
    """Render spp samples per pixel with lane refill: a pool of
    _pool_size lanes in which a lane whose path has ended takes the next
    (sample, pixel) work item, so that no lane idles through a bounce
    tail (tracer_tpu/engine/integrator.py:436-984). Sample s of pixel p
    draws from make_streams(seed, nonce + s, p), as render_frames does;
    (row0, full_h) render rows row0 .. row0 + h of a frame full_h high.

    Returns {"img": (h, w, 3) f32, "rays_traced": int (3 x active lanes
    per iteration), "iters": int (iterations with an active lane)} and,
    with with_points, "points": (pos (3, N), distance (N,), intensity
    (N,)). Every (sample, pixel) writes a slot of its own and the slots
    are merged in sample order, so image and points do not depend on the
    order in which lanes finish: the colour is the mean over samples, the
    distance that of the smallest s with a windowed return, the point
    the strict minimum in distance, a tie going to the larger s
    (merge_returns). Neither refill nor accumulation reads the host; the
    counts are read once at the end (render_pooled_tensors leaves them
    on the device), host read pool.counts, and added to the counters
    pool.live_lanes (active lanes summed over iterations, rays_traced /
    3), pool.lane_iters (lanes x iters) and pool.iters (utils/profiling).
    "lanes" is P."""
    out = render_pooled_tensors(seed, nonce, scene, cam, ambience, w, h,
                                transmitter_kind, spp, render_mode, row0,
                                full_h, with_points)
    with profiling.host_read("pool.counts"):
        out["rays_traced"], out["iters"] = torch.stack(
            [out["rays_traced"], out["iters"]]).tolist()
    profiling.count("pool.live_lanes", out["rays_traced"] // 3)
    profiling.count("pool.lane_iters", out["lanes"] * out["iters"])
    profiling.count("pool.iters", out["iters"])
    return out


def render_pooled_tensors(seed, nonce, scene: scene_mod.Scene,
                          cam: cam_mod.Camera, ambience, w: int, h: int,
                          transmitter_kind: str, spp: int, render_mode: str,
                          row0: int = 0, full_h: int | None = None,
                          with_points: bool = False):
    """render_pooled with "rays_traced" and "iters" as 0-d int64 tensors
    on the device: it reads no host value, and seed and nonce may be 0-d
    tensors, so torch.export captures it (engine/api.step_core). Spans
    pool.round (each round of _pool_round) and pool.merge (the sample-order
    merge)."""
    _check_modes(transmitter_kind, render_mode)
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    full_h = h if full_h is None else full_h
    dev = cam.origin.device
    n = w * h
    color = render_mode == "color"
    pool = _pool_size(n, spp, _scene_t_pad(scene))
    slot_bytes = (5 if color else 4) + (20 if with_points else 0)
    per_round = max(1, min(spp, STORE_BYTES // (n * slot_bytes)))

    n_channels = cam.conf.sensor_color.shape[0]
    acc = torch.zeros((3, n), device=dev) if color else None
    first_d = None if color else torch.full((n,), float("inf"), device=dev)
    best = None
    lives = []
    for s0 in range(0, spp, per_round):
        s1 = min(spp, s0 + per_round)
        with profiling.span("pool.round"):
            store, live = _pool_round(
                seed, (nonce + s0) & prng.MASK, scene, cam, ambience, w, h,
                transmitter_kind, s1 - s0, row0, full_h, pool, color,
                with_points, 1.0 / spp)
        lives.append(live)
        with profiling.span("pool.merge"):
            if color:
                for k in range(s1 - s0):   # in sample order, as render_frames
                    hue = cam.conf.sensor_color[store["chan"][k].long()].T
                    acc += (store["rad"][k] * hue) * float(n_channels)
            else:
                mind = store["mind"]
                k = torch.isfinite(mind).to(torch.uint8).argmax(dim=0)
                first_d = torch.where(torch.isfinite(first_d), first_d,
                                      torch.gather(mind, 0, k[None])[0])
            if with_points:
                mind = store["mind"]
                best_d = mind.amin(dim=0)
                has = torch.isfinite(best_d)
                # the last sample at the least distance
                k = (s1 - s0 - 1) - (mind.flip(0) == best_d).to(
                    torch.uint8).argmax(dim=0)
                pos = torch.gather(store["pos"], 1,
                                   k[None, None].expand(3, 1, -1)).squeeze(1)
                inten = torch.gather(store["int"], 0, k[None])[0]
                new = (torch.where(has, pos, -1.0), best_d,
                       torch.where(has, inten, 0.0))
                best = new if best is None else merge_returns(best, new)
    with profiling.span("pool.merge"):
        if color:
            img = la.v3_to_array(acc * (1.0 / spp)).reshape(h, w, 3)
        else:
            img = la.v3_to_array(_distance_rgb(first_d)).reshape(h, w, 3)
        live = torch.cat(lives)
        out = {"img": img, "rays_traced": 3 * live.sum(),
               "iters": (live > 0).sum(), "lanes": pool}
    if with_points:
        out["points"] = best
    return out
