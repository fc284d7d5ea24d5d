"""The plain reference of the benchmark: the renderer's per-sample
estimator in numpy float32, lane for lane.

A frozen copy of verify/lockstep.py's frame (the tracer's draw order on
the formulas of verify/ref_estimator_numpy.py, the line-by-line numpy
reading of the reference estimator), with what those two lack: any
sensor of the three configurations' shape (channels, field of view,
jitter radius), the scanning LiDAR transmitter (an 8-sector disk fan at
the camera facing each lane's primary ray, a 3-degree frustum light
beside the scene's lights) and the records distance mode reads. It
imports nothing of the program; its triangle queries are the brute
force of reference/intersect.py.

One lane is one (sample, pixel) work item: it draws from the PCG stream
make_streams(seed, nonce, pixel) and runs <= 16 bounces of closest hit,
NEE + MIS toward one uniformly chosen light (both halves' shadow rays),
one BSDF sample and unit-weight Russian roulette. trace() returns each
lane's channel, its primary ray and its per-bounce records.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from portbench.reference.intersect import Triangles

F = np.float32
U64 = np.uint64
M32 = U64(0xFFFFFFFF)
MULT, INC = U64(747796405), U64(2891336453)
PI = F(np.pi)
INV_PI = F(1.0 / np.pi)
PATH_LEN = 16
ACNE_EPS = F(0.001)
TRI_EPS = F(0.00001)
OCCLUSION_EPS = F(0.01)
FMAX = F(np.finfo(np.float32).max)
LIDAR_MIN_D, LIDAR_MAX_D = F(0.5), F(10.0)
PDF_IMPOSSIBLE, PDF_DELTA, PDF_NONZERO = 0, 1, 2
TRANSMITTER_SECTORS = 8


# ---------------------------------------------------------------------------
# PCG streams (ops/rng.py's constants and mappings)

def _permute(st):
    word = (((st >> ((st >> U64(28)) + U64(4))) ^ st) * U64(277803737)) & M32
    return (word >> U64(22)) ^ word


def hash_u32(x):
    return _permute((np.asarray(x, U64) * MULT + INC) & M32)


def make_streams(seed, frames, lanes):
    """Per-lane states: frames and lanes (L,) u32 words."""
    base = hash_u32(U64(int(seed) & 0xFFFFFFFF)
                    ^ hash_u32(np.asarray(frames, U64)))
    return hash_u32(np.asarray(lanes, U64) ^ base)


def next_u32(st):
    st = (st * MULT + INC) & M32
    return st, _permute(st)


def next_unit(st):
    st, bits = next_u32(st)
    return st, (bits >> U64(8)).astype(F) * F(0.9999 / (1 << 24))


def next_uniform(st, lo, hi):
    st, bits = next_u32(st)
    u = (bits >> U64(8)).astype(F) * F(1.0 / (1 << 24))
    return st, (F(lo) + u * F(hi - lo)).astype(F)


def select(st, n):
    st, bits = next_u32(st)
    return st, (bits % U64(n)).astype(np.int64)


def in_unit_square(st):
    st, x = next_unit(st)
    st, y = next_unit(st)
    return st, (x, y)


def in_unit_disk_xy(st):
    st, theta = next_uniform(st, 0.0, 2.0 * np.pi)
    st, u = next_unit(st)
    r = np.sqrt(u)
    return st, (r * np.cos(theta).astype(F), r * np.sin(theta).astype(F))


def in_triangle(st):
    st, (u, v) = in_unit_square(st)
    su = np.sqrt(u)
    return st, ((1.0 - su).astype(F), (v * su).astype(F))


_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_SALT_WAVELENGTH = 0x3C6EF372


def threefry2x32(key0, key1, x0, x1):
    k0, k1 = U64(key0) & M32, U64(key1) & M32
    k2 = k0 ^ k1 ^ U64(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = (np.asarray(x0, U64) + k0) & M32
    x1 = (np.asarray(x1, U64) + k1) & M32
    for i in range(5):
        for r in _TF_ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << U64(r)) | (x1 >> U64(32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + U64(i + 1)) & M32
    return x0, x1


# ---------------------------------------------------------------------------
# linalg, spectrum, materials (verify/ref_estimator_numpy.py)

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)


def norm(a):
    return np.sqrt(dot(a, a))


def normalise(a):
    with np.errstate(invalid="ignore", divide="ignore"):
        return (a / norm(a)[..., None]).astype(F)


def normalise_eps(a):
    return (a / np.maximum(norm(a), F(1e-30))[..., None]).astype(F)


def lerp(a, b, r):
    return ((1.0 - r) * a + r * b).astype(F)


def same_side(dominant, w):
    return (np.sign(dot(dominant, w))[..., None] * w).astype(F)


def spectrum_lookup(v, knots):
    """v (L,), knots (L, 6, 2) or (6, 2): the 6-knot fold with the
    sentinel semantics of spectrum.fut:30-49."""
    w_below = np.full(np.shape(v), -1.0, F)
    x_below = np.zeros(np.shape(v), F)
    w_above = np.full(np.shape(v), np.inf, F)
    x_above = np.zeros(np.shape(v), F)
    for k in range(6):
        w, x = knots[..., k, 0], knots[..., k, 1]
        is_below = (w > w_below) & (w <= v)
        is_above = (w < w_above) & (w > v)
        w_below = np.where(is_below, w, w_below)
        x_below = np.where(is_below, x, x_below)
        w_above = np.where(is_above & ~is_below, w, w_above)
        x_above = np.where(is_above & ~is_below, x, x_above)
    none_below, none_above = w_below < 0, np.isinf(w_above)
    with np.errstate(invalid="ignore", divide="ignore"):
        interp = lerp(x_below, x_above, (v - w_below) / (w_above - w_below))
    out = np.where(none_below & none_above, F(0),
                   np.where(none_below, x_above,
                            np.where(none_above, x_below, interp)))
    return out.astype(F)


class Mats:
    def __init__(self, rows):
        rows = np.asarray(rows, F)
        self.color = rows[:, 0:12].reshape(-1, 6, 2)
        self.roughness = rows[:, 12]
        self.metalness = rows[:, 13]
        self.ref_ix = rows[:, 14]
        self.opacity = rows[:, 15]
        self.emission = rows[:, 16:28].reshape(-1, 6, 2)


class MatAtWavelen:
    def __init__(self, mats: Mats, mat_ix, wavelen):
        self.color = spectrum_lookup(wavelen, mats.color[mat_ix])
        self.roughness = mats.roughness[mat_ix]
        self.metalness = mats.metalness[mat_ix]
        self.ref_ix = (mats.ref_ix[mat_ix]
                       - (wavelen - F(589)) / F(10000)).astype(F)
        self.opacity = mats.opacity[mat_ix]


def mkray_adjust_acne(hit_pos, hit_normal, wi):
    off = ACNE_EPS * same_side(wi, hit_normal)
    return (hit_pos + off).astype(F), normalise(wi)


def hit_one_triangle(origin, direction, tmax, a3, b3, c3):
    """The Moller test against one triangle per lane: (valid, pos)."""
    e1, e2 = (b3 - a3).astype(F), (c3 - a3).astype(F)
    n = cross(e1, e2)
    a = -dot(n, direction)
    s = (origin - a3).astype(F)
    m = cross(s, direction)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        inv_a = F(1.0) / a
        t = dot(n, s) * inv_a
        u = dot(m, e2) * inv_a
        v = -dot(m, e1) * inv_a
    valid = ((np.abs(a) >= TRI_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t < tmax) & (t > 0))
    with np.errstate(invalid="ignore", over="ignore"):
        pos = (origin + t[..., None] * direction).astype(F)
    return valid, pos


def mk_onb(normal):
    ax = np.abs(normal[..., 0]) > np.abs(normal[..., 2])
    zero = np.zeros_like(normal[..., 0])
    binormal = np.where(
        ax[..., None],
        np.stack([-normal[..., 1], normal[..., 0], zero], axis=-1),
        np.stack([zero, -normal[..., 2], normal[..., 1]], axis=-1))
    binormal = normalise(binormal)
    return cross(binormal, normal), binormal, normal


def world_to_local(onb, w):
    t, b, n = onb
    return np.stack([dot(w, t), dot(w, b), dot(w, n)], axis=-1).astype(F)


def local_to_world(onb, w):
    t, b, n = onb
    return (w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n).astype(F)


def cos_theta(w):
    return w[..., 2]


def sin2_theta(w):
    return np.maximum(F(0), 1 - cos_theta(w) ** 2)


def tan2_theta(w):
    with np.errstate(invalid="ignore", divide="ignore"):
        return sin2_theta(w) / (cos_theta(w) ** 2)


def tan_theta(w):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.sqrt(sin2_theta(w)) / cos_theta(w)


def same_hemisphere(w, u):
    return cos_theta(w) * cos_theta(u) > 0


def reflect(w, n):
    return (-w + 2 * dot(w, n)[..., None] * n).astype(F)


def beckmann_alpha(roughness):
    return (F(1.62142) * np.maximum(F(0.004), roughness)).astype(F)


def microfacet_distribution(alpha, wh):
    t2 = tan2_theta(wh)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        d = (np.exp(-t2 / (alpha * alpha))
             / (PI * alpha * alpha * cos_theta(wh) ** 4))
    return np.where(np.isinf(t2) | ~np.isfinite(d), F(0), d).astype(F)


def self_shadowing_factor(alpha, wo, wi):
    def lam(w):
        att = np.abs(tan_theta(w))
        with np.errstate(invalid="ignore", divide="ignore"):
            a = 1.0 / (alpha * att)
            val = np.where(a >= 1.6, F(0),
                           (1 - 1.259 * a + 0.396 * a * a)
                           / (3.535 * a + 2.181 * a * a))
        return np.where(np.isinf(att) | np.isnan(att), F(0), val)
    return (1.0 / (1.0 + lam(wo) + lam(wi))).astype(F)


def microfacet_factor(wo, wi, m):
    wh = normalise(wo + wi)
    alpha = beckmann_alpha(m.roughness)
    return (microfacet_distribution(alpha, wh)
            * self_shadowing_factor(alpha, wo, wi)).astype(F)


def fresnel_reflectance(wo, m):
    r0 = ((1 - m.ref_ix) / (1 + m.ref_ix)) ** 2
    return (r0 + (1 - r0) * (1 - cos_theta(wo)) ** 5).astype(F)


def diffuse_bsdf(m):
    return (m.color * INV_PI).astype(F)


def diffuse_pdf(wo, wi):
    return np.where(same_hemisphere(wo, wi),
                    cos_theta(wi) * INV_PI, F(0)).astype(F)


def dielectric_reflection_bsdf(wo, wi, m):
    with np.errstate(invalid="ignore", divide="ignore"):
        v = microfacet_factor(wo, wi, m) / (4 * cos_theta(wo) * cos_theta(wi))
    return v.astype(F)


def dielectric_reflection_pdf(wo, wi, m):
    wh = normalise(wo + wi)
    alpha = beckmann_alpha(m.roughness)
    wh_pdf = microfacet_distribution(alpha, wh) * np.abs(cos_theta(wh))
    with np.errstate(invalid="ignore", divide="ignore"):
        pdf = wh_pdf / (4 * dot(wo, wh))
    return np.where(same_hemisphere(wo, wi), pdf, F(0)).astype(F)


def dielectric_refraction_bsdf(m):
    return lerp(F(0), diffuse_bsdf(m), m.opacity)


def dielectric_refraction_pdf(wo, wi, m):
    return lerp(F(0), diffuse_pdf(wo, wi), m.opacity)


def dielectric_bsdf(wo, wi, m):
    refl = np.where(cos_theta(wo) <= 0, F(0), fresnel_reflectance(wo, m))
    return lerp(dielectric_refraction_bsdf(m),
                dielectric_reflection_bsdf(wo, wi, m), refl)


def dielectric_pdf(wo, wi, m):
    inside = cos_theta(wo) <= 0
    outside_pdf = lerp(dielectric_refraction_pdf(wo, wi, m),
                       dielectric_reflection_pdf(wo, wi, m),
                       fresnel_reflectance(wo, m))
    return np.where(inside, dielectric_refraction_pdf(wo, wi, m),
                    outside_pdf).astype(F)


def metal_bsdf(wo, wi, m):
    return (m.color * dielectric_reflection_bsdf(wo, wi, m)).astype(F)


def uber_bsdf(wo, wi, m):
    return lerp(dielectric_bsdf(wo, wi, m), metal_bsdf(wo, wi, m),
                m.metalness)


def uber_pdf(wo, wi, m):
    """The reference's reversed lerp order (metal first) is kept."""
    return lerp(dielectric_reflection_pdf(wo, wi, m),
                dielectric_pdf(wo, wi, m), m.metalness)


def bsdf_f(wo, wi, normal, m):
    onb = mk_onb(normal)
    return uber_bsdf(world_to_local(onb, wo), world_to_local(onb, wi), m)


def bsdf_pdf(wo, wi, normal, m):
    onb = mk_onb(normal)
    return uber_pdf(world_to_local(onb, wo), world_to_local(onb, wi), m)


def transmission_sample_dir(wo, m):
    entering = cos_theta(wo) > 0
    nloc = np.zeros_like(wo)
    nloc[..., 2] = np.where(entering, 1.0, -1.0)
    eta = np.where(entering, 1.0 / m.ref_ix, m.ref_ix).astype(F)
    cos_i = dot(nloc, wo)
    sin2_t = eta * eta * np.maximum(F(0), 1 - cos_i * cos_i)
    cos_t = np.sqrt(np.maximum(F(0), 1 - sin2_t))
    wt = (-eta[..., None] * wo
          + (eta * cos_i - cos_t)[..., None] * nloc).astype(F)
    wi = np.where((sin2_t >= 1)[..., None], reflect(wo, nloc), wt).astype(F)
    with np.errstate(invalid="ignore", divide="ignore"):
        b = (1.0 / np.abs(cos_theta(wi))).astype(F)
    return wi, b


def sample_dir(st, wo_world, normal, m):
    """The uber BSDF's sample in the tracer's draw discipline: three
    branch draws, then every candidate drawn (Beckmann reflection,
    cosine diffuse, transmission), one picked per lane. Returns (st, wi,
    bsdf, pdf, kind)."""
    onb = mk_onb(normal)
    wo = world_to_local(onb, wo_world)
    st, p_metal = next_unit(st)
    st, p_fres = next_unit(st)
    st, p_opac = next_unit(st)

    st, (u0, u1) = in_unit_square(st)
    with np.errstate(divide="ignore"):
        log_sample = np.log(1 - u0).astype(F)
    alpha = beckmann_alpha(m.roughness)
    t2 = -alpha * alpha * log_sample
    phi = (u1 * F(2 * np.pi)).astype(F)
    ct = (1.0 / np.sqrt(1 + t2)).astype(F)
    stheta = np.sqrt(np.maximum(F(0), 1 - ct * ct))
    wh = np.stack([stheta * np.cos(phi), stheta * np.sin(phi), ct],
                  axis=-1).astype(F)
    wh = np.where(same_hemisphere(wo, wh)[..., None], wh, -wh)
    pdf_wh = (microfacet_distribution(alpha, wh) * np.abs(ct)).astype(F)
    bad = np.isinf(log_sample)
    wh = np.where(bad[..., None], F(0), wh)
    pdf_wh = np.where(bad, F(0), pdf_wh)
    wi_r = reflect(wo, wh)
    with np.errstate(invalid="ignore", divide="ignore"):
        pdf_r = (pdf_wh / (4 * dot(wo, wh))).astype(F)
    kind_r = np.where(pdf_wh > 0, PDF_NONZERO, PDF_IMPOSSIBLE)
    ok = same_hemisphere(wo, wi_r)
    bsdf_r = np.where(ok, dielectric_reflection_bsdf(wo, wi_r, m), F(0))
    kind_r = np.where(ok, kind_r, PDF_IMPOSSIBLE)
    wi_r = np.where(ok[..., None], wi_r, F(0))
    pdf_r = np.where(ok, pdf_r, F(0))

    st, (dx, dy) = in_unit_disk_xy(st)
    z = np.sqrt(np.maximum(F(0), 1 - (dx * dx + dy * dy)))
    wi_d = np.stack([dx, dy, z], axis=-1).astype(F)
    bsdf_d = diffuse_bsdf(m)
    pdf_d = (cos_theta(wi_d) * INV_PI).astype(F)

    wi_t, bsdf_t = transmission_sample_dir(wo, m)

    metal_branch = p_metal < m.metalness
    refl_branch = ((~metal_branch) & ~(cos_theta(wo) <= 0)
                   & (p_fres < fresnel_reflectance(wo, m)))
    use_refl = metal_branch | refl_branch
    diffuse_branch = (~use_refl) & (p_opac < m.opacity)
    bsdf_refl = np.where(metal_branch, (m.color * bsdf_r).astype(F), bsdf_r)
    wi = np.where(use_refl[..., None], wi_r,
                  np.where(diffuse_branch[..., None], wi_d, wi_t))
    bsdf = np.where(use_refl, bsdf_refl,
                    np.where(diffuse_branch, bsdf_d, bsdf_t)).astype(F)
    pdf = np.where(use_refl, pdf_r,
                   np.where(diffuse_branch, pdf_d, F(0))).astype(F)
    kind = np.where(use_refl, kind_r,
                    np.where(diffuse_branch, PDF_NONZERO, PDF_DELTA))
    return st, local_to_world(onb, wi), bsdf, pdf, kind


# ---------------------------------------------------------------------------
# the sensor and the camera (models/camera.py, models/sensors.py)

class Sensor(NamedTuple):
    """A sensor configuration: channels (mu, sigma, colour), the thin
    lens (field of view in degrees, jitter radius) and the transmitter
    (kind "none" or "scanning", radius, half angle in degrees, uniform
    emission)."""
    mu: np.ndarray
    sigma: np.ndarray
    color: np.ndarray
    fov_deg: float
    offset_radius: float
    render_mode: str
    transmitter: str = "none"
    trans_radius: float = 0.0
    trans_theta_deg: float = 0.0
    trans_emission: float = 0.0


SENSORS = {
    0: Sensor(mu=np.array([455.0, 535.0, 610.0], F),
              sigma=np.array([22.0, 32.0, 26.0], F),
              color=np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], F),
              fov_deg=80.0, offset_radius=1.0, render_mode="color"),
    2: Sensor(mu=np.array([1550.0], F), sigma=np.array([10.0], F),
              color=np.array([[1, 0, 0]], F), fov_deg=90.0,
              offset_radius=0.01, render_mode="distance",
              transmitter="scanning", trans_radius=0.01,
              trans_theta_deg=3.0, trans_emission=1500.0),
}


def probit(p):
    """Inverse normal CDF (Acklam's rational approximation)."""
    p = np.asarray(p, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    q = np.sqrt(-2 * np.log(np.clip(p, 1e-300, None)))
    lo = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
           + c[5])
          / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    qh = np.sqrt(-2 * np.log(np.clip(1 - p, 1e-300, None)))
    hi = -((((((c[0] * qh + c[1]) * qh + c[2]) * qh + c[3]) * qh + c[4])
            * qh + c[5])
           / ((((d[0] * qh + d[1]) * qh + d[2]) * qh + d[3]) * qh + 1))
    r = p - 0.5
    s = r * r
    mid = ((((((a[0] * s + a[1]) * s + a[2]) * s + a[3]) * s + a[4]) * s
            + a[5]) * r
           / (((((b[0] * s + b[1]) * s + b[2]) * s + b[3]) * s + b[4]) * s
              + 1))
    return np.where(p < plow, lo, np.where(p > phigh, hi, mid)).astype(F)


def sample_wavelength(st, sensor: Sensor):
    """Channel and probit wavelength from one threefry block over the
    pre-advance state; the stream advances twice."""
    b0, b1 = threefry2x32(_SALT_WAVELENGTH, 0x9E3779B9, st, 0x85EBCA6B)
    st, _ = next_u32(st)
    st, _ = next_u32(st)
    ch = (b0 % U64(len(sensor.mu))).astype(np.int64)
    p = (b1 >> U64(8)).astype(F) * F(0.9999 / (1 << 24))
    wl = (sensor.mu[ch] + sensor.sigma[ch]
          * probit(np.maximum(p, F(1e-12)))).astype(F)
    return st, wl, ch


def sample_ray(st, sensor: Sensor, origin, w, h, jx, iy):
    """The jittered pinhole ray at pitch = yaw = 0 (aperture 0): one
    in_unit_square draw. Returns the INCOMING state (the reference's
    jitter-reuse quirk), the origin (L, 3) and the unit direction."""
    _, (ox, oy) = in_unit_square(st)
    x = ((jx + ox * F(sensor.offset_radius)) / F(w)).astype(F)
    y = ((iy + oy * F(sensor.offset_radius)) / F(h)).astype(F)
    half_h = np.tan(F(math.radians(sensor.fov_deg)) / F(2.0)).astype(F)
    half_w = (F(w) / F(h)) * half_h
    u = np.array([1, 0, 0], F)
    v = np.array([0, 1, 0], F)
    w_vec = np.array([0, 0, 1], F)
    lower_left = origin - half_w * u - half_h * v - w_vec
    target = (lower_left + x[:, None] * (2 * half_w * u)
              + y[:, None] * (2 * half_h * v))
    d = target - origin
    return st, np.broadcast_to(origin, d.shape).astype(F), normalise(d)


def transmitter_fan(sensor: Sensor, origin, ray_dir):
    """The scanning fan: TRANSMITTER_SECTORS triangles (p, p + r v1,
    p + r v0) around the camera origin p, facing each lane's primary
    direction (L, 3). Returns (a, b, c), each (S, L, 3)."""
    n = ray_dir
    up_axis = np.broadcast_to(np.array([0, 1, 0], F), n.shape)
    c = cross(n, up_axis)
    cq = dot(c, c)
    safe = c / np.sqrt(np.maximum(cq, F(1e-30)))[..., None]
    right = np.where((cq == 0)[..., None], np.array([1, 0, 0], F), safe)
    up = normalise_eps(cross(right, n))
    p = np.broadcast_to(np.asarray(origin, F), n.shape)
    step = 2.0 * math.pi / TRANSMITTER_SECTORS
    a_s, b_s, c_s = [], [], []
    for i in range(TRANSMITTER_SECTORS):
        v0 = F(math.cos(step * i)) * right + F(math.sin(step * i)) * up
        v1 = (F(math.cos(step * (i + 1))) * right
              + F(math.sin(step * (i + 1))) * up)
        a_s.append(p)
        b_s.append(p + F(sensor.trans_radius) * v1)
        c_s.append(p + F(sensor.trans_radius) * v0)
    return (np.stack(a_s).astype(F), np.stack(b_s).astype(F),
            np.stack(c_s).astype(F))


# ---------------------------------------------------------------------------
# the scene, the lights and next-event estimation (engine/direct.py)

class Scene:
    """The triangles (brute force on `device`), the materials and the
    scene's lights: every triangle whose material emits, in input
    order."""

    def __init__(self, tris, tri_mats, mat_rows, device="cpu",
                 precision="float32"):
        tris = np.asarray(tris, F)
        self.tris = Triangles(tris, device, precision)
        self.mat_ix = np.asarray(tri_mats, np.int64)
        e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
        self.n_unit = normalise(cross(e1, e2))
        self.mats = Mats(mat_rows)
        em = self.mats.emission[self.mat_ix]
        sel = np.nonzero(((em[:, :, 0] >= 0) & (em[:, :, 1] > 0))
                         .any(axis=1))[0]
        self.light_a, self.light_b, self.light_c = (tris[sel, k]
                                                    for k in range(3))
        self.light_em = em[sel]
        self.n_lights = len(sel)

    def closest(self, o, d, live):
        """Closest hit of the live lanes; the others miss."""
        n = o.shape[0]
        hit, t, ix = np.zeros(n, bool), np.full(n, np.inf, F), \
            np.zeros(n, np.int64)
        idx = np.nonzero(live)[0]
        if len(idx):
            hit[idx], t[idx], ix[idx] = self.tris.closest(o[idx], d[idx],
                                                          FMAX)
        t = np.where(hit, t, F(np.inf)).astype(F)
        with np.errstate(invalid="ignore"):
            pos = (o + np.where(hit, t, F(0))[:, None] * d).astype(F)
        return hit, t, pos, self.n_unit[ix], self.mat_ix[ix]

    def occluded(self, hit_pos, hit_normal, lightp, live):
        """The shadow query toward lightp: backfacing, or a triangle
        before the point (minus 0.01); lanes not live are not traced."""
        v = lightp - hit_pos
        w = normalise_eps(v)
        o, d = mkray_adjust_acne(hit_pos, hit_normal, w)
        backface = dot(w, hit_normal) <= 0
        tmax = np.where(live, norm(v) - OCCLUSION_EPS, F(0)).astype(F)
        blocked = np.zeros(live.shape, bool)
        idx = np.nonzero(live & ~backface & (tmax > 0))[0]
        if len(idx):
            blocked[idx] = self.tris.any(o[idx], d[idx], tmax[idx])
        return backface | blocked


def _incident(kind_frustum, em, theta, hitp, lightp, la, lb, lc):
    v = lightp - hitp
    wi = normalise_eps(v)
    dist_sq = np.maximum(dot(v, v), F(1e-30))
    lnormal = normalise_eps(cross(lb - la, lc - la))
    cos_l = dot(-wi, lnormal)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        diffuse = np.maximum(em * cos_l / dist_sq, F(0)).astype(F)
        inside = np.arccos(np.clip(cos_l, F(-1), F(1))) <= theta
        frustum = np.where(inside, em / dist_sq, F(0)).astype(F)
    return np.where(kind_frustum, frustum, diffuse).astype(F)


def direct_radiance(st, scene: Scene, sensor: Sensor, fan, wo, pos, normal,
                    m, wl, live):
    """One light picked uniformly from the scene's lights and the fan's
    sectors; a light-area sample and a BSDF sample combined by the
    balance heuristic; scaled by the light count."""
    n_trans = TRANSMITTER_SECTORS if fan is not None else 0
    n_lights = scene.n_lights + n_trans
    if n_lights == 0:
        return st, np.zeros(wl.shape, F)
    st, li = select(st, n_lights)
    si = np.clip(li, 0, max(scene.n_lights - 1, 0))
    la, lb, lc = scene.light_a[si], scene.light_b[si], scene.light_c[si]
    em = spectrum_lookup(wl, scene.light_em[si])
    frustum = np.zeros(wl.shape, bool)
    theta = np.zeros(wl.shape, F)
    if n_trans:
        is_t = li >= scene.n_lights
        ti = np.clip(li - scene.n_lights, 0, n_trans - 1)
        lane = np.arange(wl.shape[0])
        la = np.where(is_t[:, None], fan[0][ti, lane], la)
        lb = np.where(is_t[:, None], fan[1][ti, lane], lb)
        lc = np.where(is_t[:, None], fan[2][ti, lane], lc)
        knots = np.full((6, 2), [-1.0, 0.0], F)
        knots[0] = [0.0, sensor.trans_emission]
        em = np.where(is_t, spectrum_lookup(wl, knots), em)
        frustum = is_t
        theta = np.where(is_t, F(math.radians(sensor.trans_theta_deg)),
                         F(0)).astype(F)
    e1, e2 = lb - la, lc - la
    area = (norm(cross(e1, e2)) * F(0.5)).astype(F)
    inv_area = (F(1.0) / np.maximum(area, F(1e-30))).astype(F)

    # light half
    st, (u, v) = in_triangle(st)
    p = (la + u[:, None] * e1 + v[:, None] * e2).astype(F)
    wi_l = normalise_eps(p - pos)
    in_rad = _incident(frustum, em, theta, pos, p, la, lb, lc)
    f_l = (bsdf_f(wo, wi_l, normal, m)
           * np.abs(dot(wi_l, normal))).astype(F)
    scat_pdf = bsdf_pdf(wo, wi_l, normal, m)
    with np.errstate(invalid="ignore", divide="ignore"):
        w_l = (inv_area / (inv_area + scat_pdf)).astype(F)
    occ = scene.occluded(pos, normal, p, live)
    in_rad = np.where(occ, F(0), in_rad)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        light_part = (f_l * w_l * in_rad / inv_area).astype(F)
    light_part = np.where((inv_area == 0) | (in_rad == 0), F(0), light_part)

    # BSDF half, toward the same light
    st, wi_b, bsdf_b, pdf_b, kind_b = sample_dir(st, wo, normal, m)
    o2, d2 = mkray_adjust_acne(pos, normal, wi_b)
    lv, lpos = hit_one_triangle(o2, d2, FMAX, la, lb, lc)
    in_rad_b = _incident(frustum, em, theta, pos, lpos, la, lb, lc)
    occ2 = scene.occluded(pos, normal, lpos, live & lv)
    f_b = (bsdf_b * np.abs(dot(wi_b, normal))).astype(F)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        w_b = (pdf_b / (pdf_b + inv_area)).astype(F)
        nz = (f_b * in_rad_b * w_b / np.maximum(pdf_b, F(1e-30))).astype(F)
        contrib = np.where(kind_b == PDF_DELTA, (f_b * in_rad_b).astype(F),
                           np.where(kind_b == PDF_NONZERO, nz, F(0)))
    bsdf_part = np.where(lv & ~occ2, contrib, F(0)).astype(F)
    return st, ((light_part + bsdf_part) * F(n_lights)).astype(F)


# ---------------------------------------------------------------------------
# the lanes

class Paths(NamedTuple):
    """Per lane: the sensor channel, the primary ray, and per bounce the
    path distance on a hit (+inf otherwise) and the radiance recorded."""
    channel: np.ndarray   # (L,)
    origin: np.ndarray    # (L, 3)
    direction: np.ndarray  # (L, 3)
    dist: np.ndarray      # (PATH_LEN, L)
    rad: np.ndarray       # (PATH_LEN, L)


def trace(scene: Scene, sensor: Sensor, cam_origin, seed, nonces, pixels,
          w: int, h: int) -> Paths:
    """Lane k is sample stream make_streams(seed, nonces[k], pixels[k])
    of pixel pixels[k] (row-major, row 0 at the top) of a w x h frame."""
    pixels = np.asarray(pixels, np.int64)
    jx = (pixels % w).astype(F)
    iy = (F(h) - (pixels // w).astype(F) - F(1.0))
    st = make_streams(seed, np.asarray(nonces, U64) & M32, pixels)
    st, wl, ch = sample_wavelength(st, sensor)
    origin = np.asarray(cam_origin, F)
    st, o, d = sample_ray(st, sensor, origin, w, h, jx, iy)
    po, pd = o.copy(), d.copy()
    fan = (transmitter_fan(sensor, origin, pd)
           if sensor.transmitter == "scanning" else None)
    n = pixels.shape[0]
    alive = np.ones(n, bool)
    dist = np.full((PATH_LEN, n), np.inf, F)
    rad = np.zeros((PATH_LEN, n), F)
    cum = np.zeros(n, F)
    for bounce in range(PATH_LEN):
        if not alive.any():
            break
        hit, t, pos, normal, mix = scene.closest(o, d, alive)
        m = MatAtWavelen(scene.mats, mix, wl)
        wo = -d
        st, direct = direct_radiance(st, scene, sensor, fan, wo, pos,
                                     normal, m, wl, hit)
        emis = spectrum_lookup(wl, scene.mats.emission[mix])
        lit = direct + emis if bounce == 0 else direct
        cum = np.where(hit, cum + t, cum).astype(F)
        dist[bounce] = np.where(hit, cum, np.inf)
        rad[bounce] = np.where(hit, lit, F(0))
        st, wi, bsdf, pdf_val, kind = sample_dir(st, wo, normal, m)
        pdf = np.where(kind == PDF_DELTA, F(1),
                       np.where(kind == PDF_NONZERO, pdf_val,
                                F(0))).astype(F)
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            p_term = (1 - bsdf * np.abs(dot(normal, wi)) / pdf).astype(F)
        st, u = next_unit(st)
        alive = hit & (pdf != 0) & ~(u < p_term)
        o2, d2 = mkray_adjust_acne(pos, normal, wi)
        o = np.where(alive[:, None], o2, o)
        d = np.where(alive[:, None], d2, d)
    return Paths(ch, po, pd, dist, rad)


# ---------------------------------------------------------------------------
# what each entry returns, for chosen pixels

def _sample_sums(paths: Paths):
    """Each lane's radiance summed over its bounces in bounce order."""
    total = np.zeros(paths.rad.shape[1], F)
    for k in range(PATH_LEN):
        total = (total + paths.rad[k]).astype(F)
    return total


def frame_colors(paths: Paths, sensor: Sensor):
    """(L, 3): each lane's radiance on its channel's colour, times the
    channel count."""
    hue = sensor.color[paths.channel]
    return ((_sample_sums(paths)[:, None] * hue)
            * F(len(sensor.mu))).astype(F)


def render_pixels(scene, sensor, cam_origin, seed, nonce0, spp, pixels, w, h):
    """sample_n_frames' image at `pixels` (P,): the mean of samples
    nonce0 .. nonce0 + spp - 1, summed in sample order. (P, 3)."""
    pixels = np.asarray(pixels, np.int64)
    s = np.repeat(np.arange(spp), len(pixels))
    pix = np.tile(pixels, spp)
    col = frame_colors(trace(scene, sensor, cam_origin, seed,
                             (nonce0 + s) & 0xFFFFFFFF, pix, w, h), sensor)
    col = col.reshape(spp, len(pixels), 3)
    acc = np.zeros((len(pixels), 3), F)
    for k in range(spp):
        acc = (acc + col[k]).astype(F)
    return (acc * F(1.0 / spp)).astype(F)


def viewer_pixels(scene, sensor, cam_origin, seed, frames, pixels, w, h):
    """The colour image at `pixels` after `frames` steps from nonce 0
    with accumulation on: frame k (nonce k - 1) merged as
    img * ((k' - 1) / k') + new * (1 / k'), k' = k - 1 the frames
    before it, which drops frame 1. Returns ((P, 3) f32, (P, 3) uint8 as
    render() packs it: clamp to [0, 1], x 255, truncated)."""
    pixels = np.asarray(pixels, np.int64)
    s = np.repeat(np.arange(frames), len(pixels))
    pix = np.tile(pixels, frames)
    col = frame_colors(trace(scene, sensor, cam_origin, seed, s, pix, w, h),
                       sensor).reshape(frames, len(pixels), 3)
    img = col[0]
    for k in range(1, frames):
        nf = float(k)
        img = (img * F((nf - 1.0) / nf) + col[k] * F(1.0 / nf)).astype(F)
    rgb = (np.clip(img, F(0), F(1)) * F(255.0)).astype(np.int64)
    return img, rgb.astype(np.uint8)


def capture_samples(scene, sensor, cam_origin, seed, nonce0, spp, pixels,
                    w, h):
    """Each sample's return at `pixels`: the first bounce at the least
    path distance with radiance > 0 inside [0.5, 10), at origin +
    distance x primary direction, intensity / spp. ((spp, P) distances,
    inf where the sample has none; (spp, P, 4) [x, y, z, intensity])."""
    pixels = np.asarray(pixels, np.int64)
    n = len(pixels)
    s = np.repeat(np.arange(spp), n)
    paths = trace(scene, sensor, cam_origin, seed,
                  (nonce0 + s) & 0xFFFFFFFF, np.tile(pixels, spp), w, h)
    best = np.full(paths.rad.shape[1], np.inf, F)
    pos = np.zeros((paths.rad.shape[1], 3), F)
    inten = np.zeros(paths.rad.shape[1], F)
    factor = F(1.0 / spp)
    for k in range(PATH_LEN):
        r, dk = paths.rad[k], paths.dist[k]
        closer = ((r > 0) & (dk > LIDAR_MIN_D) & (dk < LIDAR_MAX_D)
                  & (dk < best))
        best = np.where(closer, dk, best)
        with np.errstate(invalid="ignore"):
            p = (paths.origin + dk[:, None] * paths.direction).astype(F)
        pos = np.where(closer[:, None], p, pos)
        inten = np.where(closer, (r * factor).astype(F), inten)
    pts = np.concatenate([pos, inten[:, None]], axis=1)
    return best.reshape(spp, n), pts.reshape(spp, n, 4)


def closest_return(best, pts):
    """sample_points_n's merge of capture_samples: each pixel's least
    distance over samples, a tie going to the later sample. (P, 4);
    (-1, -1, -1, 0) where no sample returns."""
    spp, n = best.shape
    d_min = best.min(axis=0)
    k = (spp - 1) - np.argmax(best[::-1] == d_min, axis=0)
    has = np.isfinite(d_min)
    out = pts[k, np.arange(n)]
    return np.where(has[:, None], out,
                    np.array([-1, -1, -1, 0], F)).astype(F)


def capture_pixels(scene, sensor, cam_origin, seed, nonce0, spp, pixels,
                   w, h):
    """sample_points_n's points at `pixels`: closest_return of
    capture_samples. (P, 4) [x, y, z, intensity]."""
    return closest_return(*capture_samples(scene, sensor, cam_origin, seed,
                                           nonce0, spp, pixels, w, h))
