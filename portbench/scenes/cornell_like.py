"""A Cornell-style box, a frozen copy of the procedural scene the port's
tests use: x in [-1, 1], y in [0, 2], z in [-1, 1], the camera looking
down -z; red left and green right walls, white floor, ceiling and back,
one white block and a ceiling area light, as 22 triangles (2 emitting)
and 5 material rows. It is not CornellBox-Original.obj: that has two
blocks and its own dimensions.
"""

import numpy as np

from portbench.reference.scene import mat_row, quad


def build():
    """(tris (22, 3, 3) f32, tri_mats (22,) u32, mats (5, 28) f32)."""
    white, red, green = (0.73, 0.71, 0.68), (0.63, 0.065, 0.05), \
        (0.14, 0.45, 0.09)
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

    add(quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]), 0)
    add(quad([-1, 2, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1]), 0)
    add(quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]), 0)
    add(quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]), 1)
    add(quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), 2)
    x0, x1, y1, z0, z1 = -0.45, 0.15, 1.1, -0.5, 0.1
    add(quad([x0, 0, z1], [x1, 0, z1], [x1, y1, z1], [x0, y1, z1]), 3)
    add(quad([x1, 0, z0], [x0, 0, z0], [x0, y1, z0], [x1, y1, z0]), 3)
    add(quad([x0, 0, z0], [x0, 0, z1], [x0, y1, z1], [x0, y1, z0]), 3)
    add(quad([x1, 0, z1], [x1, 0, z0], [x1, y1, z0], [x1, y1, z1]), 3)
    add(quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]), 3)
    add(quad([-0.24, 1.98, 0.16], [-0.24, 1.98, -0.22],
              [0.23, 1.98, -0.22], [0.23, 1.98, 0.16]), 4)
    return (np.asarray(tris, np.float32), np.asarray(tm, np.uint32), mats)
