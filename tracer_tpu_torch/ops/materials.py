"""Uber-BSDF material model (port of tracer_tpu/ops/materials.py).

A metalness-lerped blend of a metal and a dielectric; the dielectric
blends Fresnel-weighted Torrance-Sparrow (Beckmann) reflection against
an opacity-lerped diffuse/transmission refraction. Every function maps
over (N,) lanes with V3 = (3, N) directions, evaluated at one hero
wavelength per lane. Sampling computes every candidate lobe and selects,
so every lane draws the same uniforms and the RNG streams stay aligned
with the JAX package.

Kept on purpose, as in the JAX package:
  * uber_pdf lerps (metal, dielectric, metalness) while uber_bsdf lerps
    (dielectric, metal, metalness) (material.fut:358 vs :361);
  * the dispersion hack ref_ix' = ref_ix - (wavelen-589)/1e4;
  * Beckmann alpha = 1.62142 * max(roughness, 0.004).

tracer_tpu/ops/tables.py is not ported: its one-hot matmuls stand in for
gathers on the TPU, and here a row fetch is an index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.ops import spectrum as spec

# PDF kinds (material.fut:45-54)
PDF_IMPOSSIBLE = 0
PDF_DELTA = 1
PDF_NONZERO = 2

_EPS_ROUGHNESS = 0.004
_ALPHA_SCALE = 1.62142


class MaterialTable(nn.Module):
    """SoA material table decoded from the loader's (M, 28) rows: 12 color
    knots, roughness, metalness, ref_ix, opacity, 12 emission knots."""

    def __init__(self, mat_rows: torch.Tensor):
        super().__init__()
        m = torch.as_tensor(mat_rows, dtype=torch.float32)
        self.register_buffer("color", m[:, 0:12].reshape(-1, 6, 2).clone())
        self.register_buffer("roughness", m[:, 12].clone())
        self.register_buffer("metalness", m[:, 13].clone())
        self.register_buffer("ref_ix", m[:, 14].clone())
        self.register_buffer("opacity", m[:, 15].clone())
        self.register_buffer("emission", m[:, 16:28].reshape(-1, 6, 2).clone())


def parse_mats(mat_rows) -> MaterialTable:
    return MaterialTable(mat_rows)


class MaterialLanes(NamedTuple):
    """Per-lane material properties at one wavelength."""
    color: torch.Tensor      # (N,)
    roughness: torch.Tensor  # (N,)
    metalness: torch.Tensor  # (N,)
    ref_ix: torch.Tensor     # (N,)
    opacity: torch.Tensor    # (N,)


def at_wavelength_rows(rows_t, wavelen):
    """Evaluate materials from transposed 28-float rows (28, N) at the hero
    wavelength. Returns (MaterialLanes, emission value (N,))."""
    color = spec.lookup_pairs(
        wavelen, [(rows_t[2 * k], rows_t[2 * k + 1]) for k in range(6)])
    emission = spec.lookup_pairs(
        wavelen, [(rows_t[16 + 2 * k], rows_t[17 + 2 * k]) for k in range(6)])
    lanes = MaterialLanes(
        color=color,
        roughness=rows_t[12],
        metalness=rows_t[13],
        ref_ix=rows_t[14] - (wavelen - 589.0) / 10000.0,
        opacity=rows_t[15],
    )
    return lanes, emission


# ---------------------------------------------------------------------------
# Local frame. All vectors are V3 = (3, N).

def make_onb(normal):
    """Orthonormal basis with the normal as +z."""
    nx, ny, nz = normal[0], normal[1], normal[2]
    use_x = torch.abs(nx) > torch.abs(nz)
    zeros = torch.zeros_like(nx)
    binormal = torch.where(use_x, la.v3(-ny, nx, zeros),
                           la.v3(zeros, -nz, ny))
    binormal = la.v3_normalize(binormal, eps=1e-30)
    tangent = la.v3_cross(binormal, normal)
    return tangent, binormal, normal


def world_to_local(onb, w):
    tangent, binormal, normal = onb
    return la.v3(la.v3_dot(w, tangent), la.v3_dot(w, binormal),
                 la.v3_dot(w, normal))


def local_to_world(onb, w):
    tangent, binormal, normal = onb
    return w[0] * tangent + w[1] * binormal + w[2] * normal


def cos_theta(w):
    return w[2]


def cos2_theta(w):
    return w[2] * w[2]


def sin2_theta(w):
    return torch.clamp_min(1.0 - cos2_theta(w), 0.0)


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def same_hemisphere(w, u):
    return w[2] * u[2] > 0


def reflect(w, n):
    return 2.0 * la.v3_dot(w, n) * n - w


# ---------------------------------------------------------------------------
# Lobes

def diffuse_bsdf(m: MaterialLanes):
    return m.color * la.INV_PI


def diffuse_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), cos_theta(wi) * la.INV_PI, 0.0)


def cosine_sample_hemisphere(state):
    """Malley's method."""
    state, (dx, dy) = prng.in_unit_disk_xy(state)
    sin2t = dx * dx + dy * dy
    z = torch.sqrt(torch.clamp_min(1.0 - sin2t, 0.0))
    return state, la.v3(dx, dy, z)


def refract(wi, n, eta):
    """Snell refraction with total-internal-reflection fallback."""
    cos_i = la.v3_dot(n, wi)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wt = -eta * wi + (eta * cos_i - cos_t) * n
    return torch.where(tir, reflect(wi, n), wt), tir


def transmission_sample(wo, m: MaterialLanes):
    """Specular transmission / TIR with the reference's 1/|cos| value."""
    entering = cos_theta(wo) > 0
    local_n = la.v3_const(0.0, 0.0, 1.0, device=wo.device)
    n = torch.where(entering, local_n, -local_n)
    eta = torch.where(entering, 1.0 / m.ref_ix, m.ref_ix)
    wi, _ = refract(wo, n, eta)
    bsdf = 1.0 / torch.clamp_min(torch.abs(cos_theta(wi)), 1e-12)
    return wi, bsdf


def fresnel_reflectance(wo, m: MaterialLanes):
    """Schlick approximation, air outside."""
    r0 = ((1.0 - m.ref_ix) / (1.0 + m.ref_ix)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_theta(wo)) ** 5


def beckmann_alpha(roughness):
    return _ALPHA_SCALE * torch.clamp_min(roughness, _EPS_ROUGHNESS)


def microfacet_distribution(alpha, wh):
    """Beckmann-Spizzichino D."""
    t2 = tan2_theta(wh)
    c2 = cos2_theta(wh)
    d = torch.exp(-t2 / (alpha * alpha)) / (math.pi * alpha * alpha * c2 * c2)
    return torch.where(torch.isinf(t2) | torch.isnan(t2), 0.0, d)


def _lambda_beckmann(alpha, w):
    abs_tan = torch.sqrt(torch.clamp_min(tan2_theta(w), 0.0))
    a = 1.0 / (alpha * abs_tan)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    lam = torch.where(a >= 1.6, 0.0, lam)
    return torch.where(torch.isinf(abs_tan) | torch.isnan(abs_tan), 0.0, lam)


def self_shadowing_factor(alpha, wo, wi):
    return 1.0 / (1.0 + _lambda_beckmann(alpha, wo)
                  + _lambda_beckmann(alpha, wi))


def microfacet_factor(wo, wi, m: MaterialLanes):
    wh = la.v3_normalize(wi + wo, eps=1e-30)
    alpha = beckmann_alpha(m.roughness)
    return (microfacet_distribution(alpha, wh)
            * self_shadowing_factor(alpha, wo, wi))


def dielectric_reflection_bsdf(wo, wi, m: MaterialLanes):
    """Torrance-Sparrow without F (F is realised by sampling frequency)."""
    denom = 4.0 * cos_theta(wo) * cos_theta(wi)
    return microfacet_factor(wo, wi, m) / denom


def dielectric_reflection_pdf(wo, wi, m: MaterialLanes):
    wh = la.v3_normalize(wo + wi, eps=1e-30)
    alpha = beckmann_alpha(m.roughness)
    pdf_wh = microfacet_distribution(alpha, wh) * torch.abs(cos_theta(wh))
    pdf = pdf_wh / (4.0 * la.v3_dot(wo, wh))
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _sample_beckmann_wh(state, wo, m: MaterialLanes):
    """Sample a halfway vector from Beckmann D: (state, wh, pdf_wh)."""
    state, (u0, u1) = prng.in_unit_square(state)
    log_sample = torch.log(1.0 - u0)
    alpha = beckmann_alpha(m.roughness)
    t2 = -alpha * alpha * log_sample
    phi = u1 * 2.0 * math.pi
    ct = 1.0 / torch.sqrt(1.0 + t2)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    wh = la.v3(st * torch.cos(phi), st * torch.sin(phi), ct)
    wh = torch.where(same_hemisphere(wo, wh), wh, -wh)
    pdf_wh = microfacet_distribution(alpha, wh) * torch.abs(ct)
    bad = torch.isinf(log_sample)
    return (state, torch.where(bad, 0.0, wh),
            torch.where(bad, 0.0, pdf_wh))


def dielectric_reflection_sample(state, wo, m: MaterialLanes):
    """Returns (state, wi, bsdf, pdf, kind)."""
    state, wh, pdf_wh = _sample_beckmann_wh(state, wo, m)
    wi = reflect(wo, wh)
    pdf = pdf_wh / (4.0 * la.v3_dot(wo, wh))
    kind = torch.where(pdf_wh > 0, PDF_NONZERO, PDF_IMPOSSIBLE)
    ok = same_hemisphere(wo, wi)
    bsdf = torch.where(ok, dielectric_reflection_bsdf(wo, wi, m), 0.0)
    kind = torch.where(ok, kind, PDF_IMPOSSIBLE)
    wi = torch.where(ok, wi, 0.0)
    return state, wi, bsdf, torch.where(ok, pdf, 0.0), kind


# ---------------------------------------------------------------------------
# Composite dielectric / metal / uber evaluation

TRANSMISSION_BSDF = 0.0  # delta lobes evaluate to 0
TRANSMISSION_PDF = 0.0


def dielectric_refraction_bsdf(m: MaterialLanes):
    return la.lerp(TRANSMISSION_BSDF, diffuse_bsdf(m), m.opacity)


def dielectric_refraction_pdf(wo, wi, m: MaterialLanes):
    return la.lerp(TRANSMISSION_PDF, diffuse_pdf(wo, wi), m.opacity)


def dielectric_bsdf(wo, wi, m: MaterialLanes):
    reflectance = torch.where(cos_theta(wo) <= 0, 0.0,
                              fresnel_reflectance(wo, m))
    return la.lerp(dielectric_refraction_bsdf(m),
                   dielectric_reflection_bsdf(wo, wi, m), reflectance)


def dielectric_pdf(wo, wi, m: MaterialLanes):
    refr = dielectric_refraction_pdf(wo, wi, m)
    refl = dielectric_reflection_pdf(wo, wi, m)
    blended = la.lerp(refr, refl, fresnel_reflectance(wo, m))
    return torch.where(cos_theta(wo) <= 0, refr, blended)


def metal_bsdf(wo, wi, m: MaterialLanes):
    return m.color * dielectric_reflection_bsdf(wo, wi, m)


def metal_pdf(wo, wi, m: MaterialLanes):
    return dielectric_reflection_pdf(wo, wi, m)


def uber_bsdf(wo, wi, m: MaterialLanes):
    return la.lerp(dielectric_bsdf(wo, wi, m), metal_bsdf(wo, wi, m),
                   m.metalness)


def uber_pdf(wo, wi, m: MaterialLanes):
    # reversed lerp order on purpose, see the module docstring
    return la.lerp(metal_pdf(wo, wi, m), dielectric_pdf(wo, wi, m),
                   m.metalness)


def uber_sample_dir(state, wo, m: MaterialLanes):
    """Sample an outgoing direction in local space; every lane draws the
    uniforms of every lobe. Returns (state, wi, bsdf, pdf, kind)."""
    state, p_metal = prng.next_unit(state)
    state, p_fresnel = prng.next_unit(state)
    state, p_opacity = prng.next_unit(state)

    state, wi_r, bsdf_r, pdf_r, kind_r = dielectric_reflection_sample(
        state, wo, m)
    state, wi_d = cosine_sample_hemisphere(state)
    bsdf_d = diffuse_bsdf(m)
    pdf_d = cos_theta(wi_d) * la.INV_PI
    wi_t, bsdf_t = transmission_sample(wo, m)

    metal_branch = p_metal < m.metalness
    from_inside = cos_theta(wo) <= 0
    fresnel = fresnel_reflectance(wo, m)
    refl_branch = (~metal_branch) & (~from_inside) & (p_fresnel < fresnel)
    use_reflection = metal_branch | refl_branch
    diffuse_branch = (~use_reflection) & (p_opacity < m.opacity)

    bsdf_refl = torch.where(metal_branch, m.color * bsdf_r, bsdf_r)

    wi = torch.where(use_reflection, wi_r,
                     torch.where(diffuse_branch, wi_d, wi_t))
    bsdf = torch.where(use_reflection, bsdf_refl,
                       torch.where(diffuse_branch, bsdf_d, bsdf_t))
    pdf = torch.where(use_reflection, pdf_r,
                      torch.where(diffuse_branch, pdf_d, 0.0))
    kind = torch.where(use_reflection, kind_r,
                       torch.where(diffuse_branch, PDF_NONZERO, PDF_DELTA))
    return state, wi, bsdf, pdf, kind


# ---------------------------------------------------------------------------
# World-space wrappers

def bsdf_f(wo_world, wi_world, normal, m: MaterialLanes):
    onb = make_onb(normal)
    return uber_bsdf(world_to_local(onb, wo_world),
                     world_to_local(onb, wi_world), m)


def bsdf_pdf(wo_world, wi_world, normal, m: MaterialLanes):
    onb = make_onb(normal)
    return uber_pdf(world_to_local(onb, wo_world),
                    world_to_local(onb, wi_world), m)


def sample_dir(state, wo_world, normal, m: MaterialLanes):
    """World-space BSDF importance sample: (state, wi, bsdf, pdf, kind)."""
    onb = make_onb(normal)
    wo = world_to_local(onb, wo_world)
    state, wi, bsdf, pdf, kind = uber_sample_dir(state, wo, m)
    return state, local_to_world(onb, wi), bsdf, pdf, kind
