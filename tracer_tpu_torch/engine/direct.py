"""Next-event estimation with balance-heuristic MIS (port of
tracer_tpu/engine/direct.py).

Per bounce each live lane picks ONE light uniformly and combines a
light-area sample with a BSDF sample by the balance heuristic. Both MIS
halves' shadow queries go into one any_hit over 2N lanes, repacked so
that the first N lanes carry whichever half is live and the second N
only the lanes where both are; a half whose contribution is provably
zero is traced with tmax 0. This decides which lanes the any-hit kernel
traces. Occlusion consumes no RNG.

The transmitter fan of sensor configs 1 and 2 is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_tpu_torch.models import lights as lights_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import materials, shapes
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.ops import spectrum as spec

OCCLUSION_EPS = 0.01  # direct.fut:11


class LaneLights(NamedTuple):
    """The light each lane selected, emission at its hero wavelength."""
    kind: torch.Tensor    # (N,) f32 (lights_mod.KIND_* as float)
    a: torch.Tensor       # (3, N)
    b: torch.Tensor       # (3, N)
    c: torch.Tensor       # (3, N)
    theta: torch.Tensor   # (N,)
    em_val: torch.Tensor  # (N,)


def select_lane_light(state, scene: scene_mod.Scene, wavelen):
    """Uniformly pick one scene light per lane. Returns (state,
    LaneLights, n_lights), or (state, None, 0) without lights."""
    n_lights = scene.lights.count
    if n_lights == 0:
        return state, None, 0
    state, li = prng.select(state, n_lights)
    rows = scene.light_table[li.long()].T   # (23, N)
    em_val = spec.lookup_pairs(
        wavelen, [(rows[9 + 2 * k], rows[10 + 2 * k]) for k in range(6)])
    return state, LaneLights(kind=rows[22], a=rows[0:3], b=rows[3:6],
                             c=rows[6:9], theta=rows[21],
                             em_val=em_val), n_lights


def _shadow_ray(hit_pos, hit_normal, lightp):
    """Backface test + shadow-ray setup; the query itself is batched by
    the caller. Returns (backface, origin, dir, tmax)."""
    v = lightp - hit_pos
    w = la.v3_normalize(v, eps=1e-30)
    backface = la.v3_dot(w, hit_normal) <= 0
    dist = la.v3_norm(v)
    o, d = shapes.mkray_adjust_acne_v(hit_pos, hit_normal, w)
    return backface, o, d, dist - OCCLUSION_EPS


def balance(pdf_f, pdf_g):
    """Balance heuristic with nf = ng = 1."""
    return pdf_f / (pdf_f + pdf_g)


def incident_radiance(light: LaneLights, hitp, lightp):
    """Area/point light radiance with the spectrum value precomputed."""
    v = lightp - hitp
    wi = la.v3_normalize(v, eps=1e-30)
    dist_sq = torch.clamp_min(la.v3_quadrance(v), 1e-30)
    lnormal = shapes.triangle_normal_v(light.a, light.b, light.c)
    cos_theta_l = la.v3_dot(-wi, lnormal)
    diffuse = torch.clamp_min(light.em_val * cos_theta_l / dist_sq, 0.0)
    inside = torch.arccos(torch.clamp(cos_theta_l, -1.0, 1.0)) <= light.theta
    frustum = torch.where(inside, light.em_val / dist_sq, 0.0)
    point = light.em_val / dist_sq
    return torch.where(light.kind == lights_mod.KIND_FRUSTUM_AREA, frustum,
                       torch.where(light.kind == lights_mod.KIND_POINT, point,
                                   diffuse))


def estimate_direct(state, scene: scene_mod.Scene, wo,
                    inter: scene_mod.Interaction, light: LaneLights,
                    mask=None):
    """MIS light-sample + BSDF-sample estimate toward each lane's light.
    Returns (state, radiance (N,)). mask (N,) bool: lanes whose result the
    caller discards; their shadow rays are traced with tmax 0."""
    is_point = light.kind == lights_mod.KIND_POINT
    e1 = light.b - light.a
    e2 = light.c - light.a
    area = la.v3_norm(la.v3_cross(e1, e2)) * 0.5
    inv_area = 1.0 / torch.clamp_min(area, 1e-30)

    # light sampling
    state, (u, v) = prng.in_triangle(state)
    p_area = light.a + u * e1 + v * e2
    lightp = torch.where(is_point, light.a, p_area)
    wi_l = la.v3_normalize(lightp - inter.pos, eps=1e-30)

    in_radiance = incident_radiance(light, inter.pos, lightp)
    light_pdf = torch.where(is_point, 1.0, inv_area)

    f_l = (materials.bsdf_f(wo, wi_l, inter.normal, inter.mat)
           * torch.abs(la.v3_dot(wi_l, inter.normal)))
    scattering_pdf = materials.bsdf_pdf(wo, wi_l, inter.normal, inter.mat)
    weight_l = balance(light_pdf, scattering_pdf)

    # BSDF sampling toward the same light; zero for point lights
    state, wi_b, bsdf_b, pdf_b, kind_b = materials.sample_dir(
        state, wo, inter.normal, inter.mat)
    o_b, d_b = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi_b)
    hit_ok, _, lh_pos, _ = shapes.hit_triangle_v(
        shapes.F32_HIGHEST, o_b, d_b, light.a, light.b, light.c)

    bf_l, so_l, sd_l, st_l = _shadow_ray(inter.pos, inter.normal, lightp)
    bf_b, so_b, sd_b, st_b = _shadow_ray(inter.pos, inter.normal, lh_pos)
    in_rad_b = incident_radiance(light, inter.pos, lh_pos)

    # zero-contribution suppression: each factor also gates its part below
    live_l = (~bf_l & (light_pdf != 0) & (in_radiance != 0) & (f_l != 0)
              & (weight_l != 0))
    live_b = (~is_point & hit_ok & ~bf_b & (in_rad_b != 0)
              & (((kind_b == materials.PDF_DELTA)
                  | (kind_b == materials.PDF_NONZERO)) & (bsdf_b != 0)))
    if mask is not None:
        live_l &= mask
        live_b &= mask
    # slot 0 carries whichever half is live, slot 1 the both-live lanes
    b_only = live_b & ~live_l
    both = live_b & live_l
    n = wi_l.shape[-1]
    blocked = scene_mod.any_hit(
        scene,
        torch.cat([torch.where(live_l | live_b,
                               torch.where(b_only, st_b, st_l), 0.0),
                   torch.where(both, st_b, 0.0)]),
        torch.cat([torch.where(b_only, so_b, so_l), so_b], dim=1),
        torch.cat([torch.where(b_only, sd_b, sd_l), sd_b], dim=1))
    occ = bf_l | blocked[:n]
    occ_b = bf_b | torch.where(both, blocked[n:], blocked[:n])

    in_radiance = torch.where(occ, 0.0, in_radiance)
    light_part = torch.where(
        (light_pdf == 0) | (in_radiance == 0), 0.0,
        f_l * weight_l * in_radiance / light_pdf)

    f_b = bsdf_b * torch.abs(la.v3_dot(wi_b, inter.normal))
    weight_b = balance(pdf_b, inv_area)
    contrib = torch.where(
        kind_b == materials.PDF_DELTA, f_b * in_rad_b,
        torch.where(kind_b == materials.PDF_NONZERO,
                    f_b * in_rad_b * weight_b / torch.clamp_min(pdf_b, 1e-30),
                    0.0))
    bsdf_part = torch.where(is_point | ~hit_ok | occ_b, 0.0, contrib)
    return state, light_part + bsdf_part


def direct_radiance(state, scene: scene_mod.Scene, wo,
                    inter: scene_mod.Interaction, wavelen, mask=None):
    """One-light estimate scaled by the light count. Returns (state,
    radiance (N,))."""
    n_rays = wo.shape[-1]
    state, light, n_lights = select_lane_light(state, scene, wavelen)
    if light is None:
        return state, torch.zeros((n_rays,), device=wo.device)
    state, radiance = estimate_direct(state, scene, wo, inter, light,
                                      mask=mask)
    return state, radiance * float(n_lights)
