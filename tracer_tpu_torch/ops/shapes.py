"""Batched ray / triangle geometry (port of tracer_tpu/ops/shapes.py).

Rays are V3 = (3, N) origins and unit directions; triangles are given
by their three vertices as V3 blocks. hit_triangle keeps the (..., 3)
layout for the brute-force intersection oracle.
"""

from __future__ import annotations

import math

import torch

from tracer_tpu_torch.ops import linalg as la

ACNE_EPS = 0.001       # shapes.fut:44
TRI_EPS = 0.00001      # shapes.fut:69
AABB_EPS = 0.001       # shapes.fut:116
F32_HIGHEST = 3.4028235e38


def hit_triangle(tmax, origin, d, tri):
    """Moller-style test, elementwise over broadcast (..., 3) rays and
    (..., 3, 3) triangles. Returns (ok, t, pos, normal); t = +inf where
    the ray misses. The normal is e1 x e2 normalized, not flipped."""
    a_v = tri[..., 0, :]
    e1 = tri[..., 1, :] - a_v
    e2 = tri[..., 2, :] - a_v
    n = la.cross(e1, e2)
    a = -la.dot(n, d)
    nondeg = torch.abs(a) >= TRI_EPS
    inv_a = torch.where(nondeg, 1.0 / torch.where(nondeg, a, 1.0), 0.0)
    s = origin - a_v
    m = la.cross(s, d)
    t = la.dot(n, s) * inv_a
    u = la.dot(m, e2) * inv_a
    v = -la.dot(m, e1) * inv_a
    ok = nondeg & (u >= 0) & (v >= 0) & (u + v <= 1) & (t < tmax) & (t > 0)
    t = torch.where(ok, t, float("inf"))
    pos = origin + torch.where(ok, t, 0.0)[..., None] * d
    return ok, t, pos, la.normalize(n, eps=1e-30)


def mkray_adjust_acne_v(hit_pos, hit_normal, wi):
    """Offset the origin along the normal, flipped to wi's side."""
    offset = ACNE_EPS * la.v3_same_side(wi, hit_normal)
    return hit_pos + offset, la.v3_normalize(wi)


def triangle_normal_v(ta, tb, tc):
    return la.v3_normalize(la.v3_cross(tb - ta, tc - ta), eps=1e-30)


def hit_triangle_v(tmax, origin, d, ta, tb, tc):
    """Moller test in the transposed layout.

    Returns (ok (N,), t (N,), pos (3,N), normal (3,N)); t = +inf on miss.
    """
    ok, t, n = triangle_t_v(tmax, origin, d, ta, tb, tc)
    pos = origin + torch.where(ok, t, 0.0) * d
    normal = la.v3_normalize(n, eps=1e-30)
    return ok, t, pos, normal


def triangle_t_v(tmax, origin, d, ta, tb, tc):
    """hit_triangle_v up to t: (ok (N,), t (N,), +inf on a miss, the
    unnormalised normal (3,N)). Each f32 operation is one PyTorch op, so
    the result is the same on every device (csrc/bvh.cu computes it so
    too)."""
    e1 = tb - ta
    e2 = tc - ta
    n = la.v3_cross(e1, e2)
    a = -la.v3_dot(n, d)
    nondeg = torch.abs(a) >= TRI_EPS
    inv_a = nondeg.to(torch.float32) / torch.where(nondeg, a, 1.0)
    s = origin - ta
    m = la.v3_cross(s, d)
    t = la.v3_dot(n, s) * inv_a
    u = la.v3_dot(m, e2) * inv_a
    v = -la.v3_dot(m, e1) * inv_a
    ok = (nondeg & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t < tmax) & (t > 0))
    return ok, torch.where(ok, t, float("inf")), n


def disk_sectors_v(p, normal, radius, n_sectors: int):
    """Disk triangle fan around p facing `normal`, V3 layout
    (tracer_tpu/ops/shapes.py:172-196). p and normal broadcast to a common
    (3, N) or (3, 1); returns a list of n_sectors (a, b, c) V3 tuples. A
    normal parallel to up takes right = (1, 0, 0)."""
    a = 2.0 * math.pi / n_sectors
    up_axis = la.v3_const(0.0, 1.0, 0.0, device=normal.device)
    c = la.v3_cross(normal, up_axis.expand(normal.shape))
    cq = la.v3_quadrance(c)
    safe = c * torch.rsqrt(torch.clamp_min(cq, 1e-30))
    right = torch.where(cq == 0.0,
                        la.v3_const(1.0, 0.0, 0.0, device=normal.device), safe)
    up = la.v3_normalize(la.v3_cross(right, normal), eps=1e-30)
    out = []
    for i in range(n_sectors):
        b0, b1 = a * i, a * (i + 1)
        v0 = math.cos(b0) * right + math.sin(b0) * up
        v1 = math.cos(b1) * right + math.sin(b1) * up
        out.append((p, p + radius * v1, p + radius * v0))
    return out


# ---------------------------------------------------------------------------
# Boxes of the LBVH (tracer_tpu/ops/shapes.py:94-121): built in the (..., 3)
# layout, tested in the transposed one

def aabb_center(aabb_min, aabb_max):
    return (aabb_min + aabb_max) * 0.5


def bounding_box_triangle(tri):
    """(min (..., 3), max (..., 3)) over the three vertices of (..., 3, 3)
    triangles."""
    return tri.amin(dim=-2), tri.amax(dim=-2)


def hit_aabb_v(tmax, origin, inv_d, aabb_min, aabb_max):
    """Slab test of V3 rays, given by their origin and inv_d = 1.0 / d,
    against V3 boxes: tmin starts at 0, each axis' upper bound is
    inflated by (1 + AABB_EPS), and a box is missed when its exit is not
    after its entry (or is NaN, from 0 x inf on a box's face)."""
    t0 = (aabb_min - origin) * inv_d
    t1 = (aabb_max - origin) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1) * (1.0 + AABB_EPS)
    tmin = torch.clamp_min(torch.maximum(torch.maximum(lo[0], lo[1]), lo[2]),
                           0.0)
    tmax_ = torch.minimum(torch.minimum(torch.minimum(hi[0], hi[1]), hi[2]),
                          tmax)
    return tmax_ > tmin
