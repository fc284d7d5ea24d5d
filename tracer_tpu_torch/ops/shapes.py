"""Batched ray / triangle geometry (port of tracer_tpu/ops/shapes.py).

Rays are V3 = (3, N) origins and unit directions; triangles are given
by their three vertices as V3 blocks. hit_triangle keeps the (..., 3)
layout for the brute-force intersection oracle.
"""

from __future__ import annotations

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
    t = torch.where(ok, t, float("inf"))
    pos = origin + torch.where(ok, t, 0.0) * d
    normal = la.v3_normalize(n, eps=1e-30)
    return ok, t, pos, normal
