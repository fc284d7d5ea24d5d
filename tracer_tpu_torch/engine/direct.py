"""Next-event estimation with balance-heuristic MIS (port of
tracer_tpu/engine/direct.py).

Per bounce each live lane picks ONE light uniformly, from the scene
lights and the 8 sectors of the sensor's transmitter fan (configs 1 and
2), and combines a light-area sample with a BSDF sample by the balance
heuristic. Both MIS
halves' shadow queries go into one any_hit over 2N lanes, repacked so
that the first N lanes carry whichever half is live and the second N
only the lanes where both are; a half whose contribution is provably
zero is traced with tmax 0. This decides which lanes the any-hit kernel
traces. Occlusion consumes no RNG.

The estimate is split at that query (tracer_tpu/engine/direct.py's
estimate_direct): estimate_direct_prepare (the samples, both halves'
parts and the packed shadow rays) and estimate_direct_finish (the parts
the query leaves unoccluded). The split is the plain version of the
bounce's shading kernels (engine/shade.py, csrc/shade.cu), which hold to
it op for op; engine/shade.py composes it with the light select and the
query.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_tpu_torch.models import camera as cam_mod
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


class Transmitter(NamedTuple):
    """The sensor's transmitter fan as a light (sensor configs 1 and 2)."""
    kind: float            # lights_mod.KIND_FRUSTUM_AREA or KIND_DIFFUSE_AREA
    sectors: torch.Tensor  # (TRANSMITTER_SECTORS, 9, N or 1): a, b, c rows
    theta: torch.Tensor    # scalar, radians (the scanning frustum's)
    emission: torch.Tensor  # (6, 2) spectrum


def transmitter(cam: cam_mod.Camera, transmitter_kind: str, ray_dir):
    """The fan of camera.gen_transmitter_sectors for primary directions
    ray_dir (3, N), its sectors stacked, as a Transmitter; None without
    one. The scanning fan is a 3-degree frustum light (theta =
    trans_theta), the flash fan a diffuse one."""
    sectors = cam_mod.gen_transmitter_sectors(cam, transmitter_kind, ray_dir)
    if sectors is None:
        return None
    kind = float(lights_mod.KIND_FRUSTUM_AREA
                 if transmitter_kind == cam_mod.TRANSMITTER_SCANNING
                 else lights_mod.KIND_DIFFUSE_AREA)
    return Transmitter(kind, torch.stack([torch.cat(s) for s in sectors]),
                       cam.conf.trans_theta, cam.conf.trans_emission)


def select_lane_light(state, light_table, wavelen,
                      trans: Transmitter | None = None):
    """Uniformly pick one light per lane from the scene lights, the rows
    of the scene's packed light table (L, 23), and the transmitter fan's
    sectors (tracer_tpu/engine/direct.py:48-102): index li < n_scene is a
    row of the light table, li >= n_scene the sector li - n_scene of
    trans. Returns (state, LaneLights, n_lights), or (state, None, 0)
    without any light."""
    n_scene = light_table.shape[0]
    n_trans = 0 if trans is None else trans.sectors.shape[0]
    n_lights = n_scene + n_trans
    if n_lights == 0:
        return state, None, 0
    state, li = prng.select(state, n_lights)
    n = wavelen.shape[0]
    if n_scene > 0:
        rows = light_table[li.clamp(0, n_scene - 1).long()].T  # (23, N)
        kind, theta = rows[22], rows[21]
        va, vb, vc = rows[0:3], rows[3:6], rows[6:9]
        em_val = spec.lookup_pairs(
            wavelen, [(rows[9 + 2 * k], rows[10 + 2 * k]) for k in range(6)])
    else:
        zero = torch.zeros((n,), device=wavelen.device)
        kind, theta, em_val = zero, zero, zero
        va = vb = vc = torch.zeros((3, n), device=wavelen.device)
    if n_trans:
        ti = (li - n_scene).clamp(0, n_trans - 1).long()
        sec = torch.gather(trans.sectors.expand(n_trans, 9, n), 0,
                           ti.expand(1, 9, n))[0]  # (9, N)
        is_t = li >= n_scene
        kind = torch.where(is_t, trans.kind, kind)
        va = torch.where(is_t, sec[0:3], va)
        vb = torch.where(is_t, sec[3:6], vb)
        vc = torch.where(is_t, sec[6:9], vc)
        theta = torch.where(is_t, trans.theta, theta)
        em_val = torch.where(is_t, spec.lookup_table(wavelen, trans.emission),
                             em_val)
    return state, LaneLights(kind=kind, a=va, b=vb, c=vc, theta=theta,
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


class ShadowQuery(NamedTuple):
    """Both MIS halves' shadow rays, packed into 2N lanes: lanes 0..N carry
    whichever half is live (the light half where both are), lanes N..2N
    the BSDF half where both are; a dead slot has tmax 0."""
    tmax: torch.Tensor    # (2N,)
    origin: torch.Tensor  # (3, 2N)
    dir: torch.Tensor     # (3, 2N)


class DirectTerms(NamedTuple):
    """What estimate_direct_finish needs of estimate_direct_prepare."""
    light: torch.Tensor   # (N,) the light half's part if its ray is clear
    bsdf: torch.Tensor    # (N,) the BSDF half's part if its ray is clear
    bf_l: torch.Tensor    # (N,) bool: the light sample lies behind the surface
    bf_b: torch.Tensor    # (N,) bool: the BSDF sample's light point does
    both: torch.Tensor    # (N,) bool: both halves live (slot 1 in use)


def estimate_direct_prepare(state, wo, inter: scene_mod.Interaction,
                            light: LaneLights, mask):
    """The MIS estimate toward each lane's light up to its shadow query:
    the light and BSDF samples, both halves' contributions and their
    shadow rays. mask (N,) bool: the lanes whose result counts; the
    others' shadow rays are traced with tmax 0. Returns (state,
    ShadowQuery, DirectTerms)."""
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
    live_l &= mask
    live_b &= mask
    # slot 0 carries whichever half is live, slot 1 the both-live lanes
    b_only = live_b & ~live_l
    both = live_b & live_l
    query = ShadowQuery(
        tmax=torch.cat([torch.where(live_l | live_b,
                                    torch.where(b_only, st_b, st_l), 0.0),
                        torch.where(both, st_b, 0.0)]),
        origin=torch.cat([torch.where(b_only, so_b, so_l), so_b], dim=1),
        dir=torch.cat([torch.where(b_only, sd_b, sd_l), sd_b], dim=1))

    # each part as it is where its shadow ray is clear (an occluded light
    # half reads in_radiance 0, which the first test makes 0)
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
    bsdf_part = torch.where(is_point | ~hit_ok, 0.0, contrib)
    return state, query, DirectTerms(light_part, bsdf_part, bf_l, bf_b, both)


def estimate_direct_finish(terms: DirectTerms, blocked):
    """The MIS estimate after its shadow query: blocked (2N,) bool,
    any_hit of the ShadowQuery. Returns radiance (N,) toward the one
    light (the caller scales it by the light count)."""
    n = terms.light.shape[0]
    occ = terms.bf_l | blocked[:n]
    occ_b = terms.bf_b | torch.where(terms.both, blocked[n:], blocked[:n])
    return (torch.where(occ, 0.0, terms.light)
            + torch.where(occ_b, 0.0, terms.bsdf))

