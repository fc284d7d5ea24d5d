"""Procedural test scenes, numpy only (the Cornell box, the glass prism,
the single triangle and the midpoint subdivision of
tracer_tpu/utils/testscenes.py; the port's smoke run renders the box when
no asset file is given).

cornell_like mimics the classic Cornell box layout (coloured side walls,
white box interior, ceiling area light, one block) with the loader's
28-float material rows. subdivide turns it into a big scene with the
same surfaces: subdivide(*cornell_like()[:2], levels=6) has 22 * 4**6 =
90,112 triangles.
"""

from __future__ import annotations

import numpy as np

RED_WAVELEN, GREEN_WAVELEN, BLUE_WAVELEN = 610.0, 550.0, 460.0


def _rgb_knots(r, g, b):
    return [RED_WAVELEN, r, GREEN_WAVELEN, g, BLUE_WAVELEN, b,
            -1.0, 0.0, -1.0, 0.0, -1.0, 0.0]


def mat_row(kd=(0, 0, 0), ke=(0, 0, 0), roughness=1.0, metalness=0.0,
            ref_ix=1.0, opacity=1.0) -> np.ndarray:
    row = (_rgb_knots(*kd) + [roughness, metalness, ref_ix, opacity]
           + _rgb_knots(*ke))
    return np.asarray(row, np.float32)


def quad(a, b, c, d):
    """Two triangles for the quad a-b-c-d (fan split, like the loader)."""
    return [[a, b, c], [a, c, d]]


def cornell_like():
    """(tris (T,3,3), tri_mats (T,), mats (M,28)) for a cornell-style box:
    x in [-1,1], y in [0,2], z in [-1,1], camera looks down -z."""
    white, red, green = (0.73, 0.71, 0.68), (0.63, 0.065, 0.05), (0.14, 0.45, 0.09)
    mats = np.stack([
        mat_row(kd=white),                       # 0 floor/ceiling/back
        mat_row(kd=red),                         # 1 left wall
        mat_row(kd=green),                       # 2 right wall
        mat_row(kd=white),                       # 3 block
        mat_row(ke=(27.0, 22.0, 14.0)),          # 4 light
    ])
    tris, tm = [], []

    def add(ts, m):
        tris.extend(ts)
        tm.extend([m] * len(ts))

    add(quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]), 0)    # floor
    add(quad([-1, 2, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1]), 0)    # ceiling
    add(quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]), 0)  # back
    add(quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]), 1)  # left
    add(quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), 2)      # right
    # block
    x0, x1, y1, z0, z1 = -0.45, 0.15, 1.1, -0.5, 0.1
    add(quad([x0, 0, z1], [x1, 0, z1], [x1, y1, z1], [x0, y1, z1]), 3)
    add(quad([x1, 0, z0], [x0, 0, z0], [x0, y1, z0], [x1, y1, z0]), 3)
    add(quad([x0, 0, z0], [x0, 0, z1], [x0, y1, z1], [x0, y1, z0]), 3)
    add(quad([x1, 0, z1], [x1, 0, z0], [x1, y1, z0], [x1, y1, z1]), 3)
    add(quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]), 3)
    # ceiling light (slightly below the ceiling, facing down)
    add(quad([-0.24, 1.98, 0.16], [-0.24, 1.98, -0.22],
             [0.23, 1.98, -0.22], [0.23, 1.98, 0.16]), 4)

    return (np.asarray(tris, np.float32), np.asarray(tm, np.uint32), mats)


def prism_scene():
    """(tris, tri_mats, mats) of the glass-prism dispersion scene: a
    ceiling strip light seen through a triangular glass prism (apex down
    in (y, z), extruded along x) in a box with a red left wall. The
    wavelength-dependent refractive index fans the hero wavelengths, so
    the strip's refracted image is a rainbow band, red above blue, for a
    camera at (0, 0.9, 2.6) looking down -z."""
    white, red = (0.73, 0.71, 0.68), (0.63, 0.065, 0.05)
    mats = np.stack([
        mat_row(kd=white),                                    # 0 walls
        mat_row(kd=red),                                      # 1 left wall
        # glass: pure specular transmission; n = 1.5 keeps the exit below
        # total internal reflection
        mat_row(kd=(0, 0, 0), roughness=0.0, metalness=0.0,
                ref_ix=1.5, opacity=0.0),                     # 2 prism
        mat_row(ke=(60.0, 60.0, 60.0)),                       # 3 strip light
    ])
    tris, tm = [], []

    def add(ts, m):
        tris.extend(ts)
        tm.extend([m] * len(ts))

    add(quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]), 0)    # floor
    add(quad([-1, 2, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1]), 0)    # ceiling
    add(quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]), 0)  # back
    add(quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]), 1)  # left
    add(quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), 0)      # right

    ap = [0.95, 0.0]                 # apex (y, z)
    bf = [1.55, 0.33]                # base corner, front (+z)
    br = [1.55, -0.33]               # base corner, rear (-z)
    x0, x1 = -0.7, 0.7

    def p(v, x):
        return [x, v[0], v[1]]

    add([[p(ap, x0), p(bf, x0), p(br, x0)]], 2)                    # cap x0
    add([[p(ap, x1), p(br, x1), p(bf, x1)]], 2)                    # cap x1
    add(quad(p(ap, x0), p(ap, x1), p(bf, x1), p(bf, x0)), 2)       # front
    add(quad(p(ap, x1), p(ap, x0), p(br, x0), p(br, x1)), 2)       # rear
    add(quad(p(bf, x0), p(bf, x1), p(br, x1), p(br, x0)), 2)       # base
    # the strip light, where the exit fan crosses the ceiling
    add(quad([-0.8, 1.99, -0.55], [-0.8, 1.99, -0.65],
             [0.8, 1.99, -0.65], [0.8, 1.99, -0.55]), 3)

    return (np.asarray(tris, np.float32), np.asarray(tm, np.uint32), mats)


def single_triangle(mat=None):
    """(tris, tri_mats, mats) of the smallest scene: one triangle at
    z = -2 facing +z, of material row `mat` (a grey diffuse by default)."""
    if mat is None:
        mat = mat_row(kd=(0.8, 0.8, 0.8))
    tris = np.asarray([[[-1, -1, -2], [1, -1, -2], [0, 1, -2]]], np.float32)
    return tris, np.zeros((1,), np.uint32), mat[None]


def subdivide(tris, tri_mats, levels: int = 1):
    """Midpoint 1->4 triangle subdivision, `levels` times: the same
    surface with 4**levels times the triangles, each child keeping its
    parent's material. Returns (tris (T, 3, 3) f32, tri_mats (T,))."""
    tris = np.asarray(tris, np.float32).reshape(-1, 3, 3)
    tm = np.asarray(tri_mats)
    for _ in range(levels):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) * 0.5, (b + c) * 0.5, (c + a) * 0.5
        tris = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1),
            np.stack([ab, bc, ca], axis=1)], axis=0)
        tm = np.concatenate([tm, tm, tm, tm], axis=0)
    return tris, tm
