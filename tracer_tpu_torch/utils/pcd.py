"""ASCII PCD point-cloud writer, numpy only (a copy of
tracer_tpu/utils/pcd.py, the output path of the reference's demo-save,
demo-save/src/main.rs:24-32).

Fields x y z intensity, one point per pixel; a pixel without a return is
written as it comes from sample_points_n: x = y = z = -1, intensity 0.
"""

from __future__ import annotations

import numpy as np


def write_pcd(path: str, points) -> None:
    """points: (..., 4) array of (x, y, z, intensity); flattened to N."""
    pts = np.asarray(points, np.float32).reshape(-1, 4)
    n = pts.shape[0]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS x y z intensity",
        "SIZE 4 4 4 4",
        "TYPE F F F F",
        "COUNT 1 1 1 1",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        "DATA ascii",
    ]) + "\n"
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, pts, fmt="%.6g")
