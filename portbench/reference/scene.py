"""The benchmark's scenes, numpy only. The harness builds a
configuration's arrays here and hands the same arrays to the program and
to the reference.

A scene's generator is a file scenes/<name>.py whose build() returns
(tris (T, 3, 3) f32, tri_mats (T,) u32, mats (M, 28) f32), made with
mat_row and quad below; subdivide(levels), a frozen copy of the midpoint
subdivision the port's test scenes use, splits every triangle into 4,
levels times.
"""

from __future__ import annotations

import numpy as np

RED_WAVELEN, GREEN_WAVELEN, BLUE_WAVELEN = 610.0, 550.0, 460.0


def _rgb_knots(r, g, b):
    return [RED_WAVELEN, r, GREEN_WAVELEN, g, BLUE_WAVELEN, b,
            -1.0, 0.0, -1.0, 0.0, -1.0, 0.0]


def mat_row(kd=(0, 0, 0), ke=(0, 0, 0), roughness=1.0, metalness=0.0,
            ref_ix=1.0, opacity=1.0) -> np.ndarray:
    """One 28-float material row: colour knots, roughness, metalness,
    refractive index, opacity, emission knots."""
    row = (_rgb_knots(*kd) + [roughness, metalness, ref_ix, opacity]
           + _rgb_knots(*ke))
    return np.asarray(row, np.float32)


def quad(a, b, c, d):
    """Two triangles of the quad a b c d."""
    return [[a, b, c], [a, c, d]]


def subdivide(tris, tri_mats, levels: int):
    """Midpoint 1->4 subdivision, `levels` times; each child keeps its
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


def generate(name: str, base=None):
    """(tris, tri_mats, mats) of scenes/<name>.py's build()."""
    from portbench import harness
    return harness.module("scenes", name, base or harness.HERE).build()


def build(config: dict, base=None):
    """(tris, tri_mats, mats) of a configuration's "scene" entry:
    {"generator": name, "subdivide": levels}, the generator a file
    scenes/<name>.py of the benchmark at `base`."""
    spec = config["scene"]
    tris, tm, mats = generate(spec["generator"], base)
    levels = int(spec.get("subdivide", 0))
    if levels:
        tris, tm = subdivide(tris, tm, levels)
    return tris, tm, mats
