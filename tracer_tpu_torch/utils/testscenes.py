"""Procedural test scenes, numpy only (the Cornell box and the midpoint
subdivision of tracer_tpu/utils/testscenes.py, which the port's smoke run
renders when no asset file is given).

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
