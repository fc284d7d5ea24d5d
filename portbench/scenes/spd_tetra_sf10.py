"""The Standard Procedural Databases' `tetra` scene (E. Haines, "A
Proposal for Standard Graphics Environments", IEEE CG&A 7(11), 1987;
tetra.c of github.com/erich666/StandardProceduralDatabases) at size
factor 10, numpy only: 4^11 = 4,194,304 faces and the 2-triangle light,
4,194,306 triangles, past the port's dense cap
(tracer_tpu_torch/models/scene.DENSE_THRESHOLD).

The faces, their winding and the turn are scenes/spd_tetra.py's (faces,
rotation); every length is SCALE = 4 times that scene's. At scale 1 a
face at size factor 10 has an edge of 2.828 / 1024, so |e1 x e2| = 6.6e-6
is below the ray-triangle test's TRI_EPS = 1e-5 (shapes.fut:69) and no
ray would see it, whatever its angle. At scale 4 each face is a face of
spd_tetra at size factor 8 (|e1 x e2| = 1.06e-4): the grazing cut, the
framing (the bounding sphere of radius 4 sqrt 3 at CAMERA_DISTANCE) and
the light's irradiance (a square of side 4 at 4 times the distance) are
that scene's. Vertices are computed in float64 and cast to float32 once.
What is not read from the source is listed under `assumed` in
configs/spd-tetra-sf10-lbvh.json.
"""

import numpy as np

from portbench.reference.scene import mat_row, quad
from portbench.scenes.spd_tetra import COLOR, LIGHT_EMISSION, faces, rotation

SIZE_FACTOR = 10
SCALE = 4.0
CAMERA_ORIGIN = (0.0, 0.0, 10.8)
CAMERA_DISTANCE = 10.8
LIGHT_CENTER = (10.0, 14.0, 18.0)
LIGHT_SIDE = 4.0


def centroid() -> np.ndarray:
    return np.asarray(CAMERA_ORIGIN) - np.array([0.0, 0.0, CAMERA_DISTANCE])


def place(root_frame: np.ndarray) -> np.ndarray:
    """Points (..., 3) of the root's frame (spd_tetra.faces) in the
    world: scaled by SCALE, turned, the centroid moved to centroid()."""
    return SCALE * root_frame @ rotation().T + centroid()


def light() -> list:
    """The emitter: a square of LIGHT_SIDE at LIGHT_CENTER whose normal
    (b - a) x (c - a) points at the pyramid's centroid, as 2 triangles."""
    c = np.asarray(LIGHT_CENTER)
    n = centroid() - c
    n /= np.linalg.norm(n)
    u = np.cross(n, [0.0, 1.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    h = 0.5 * LIGHT_SIDE
    return quad(c - h * u - h * v, c + h * u - h * v, c + h * u + h * v,
                c - h * u + h * v)


def build(size_factor: int = SIZE_FACTOR):
    """(tris (4^(size_factor + 1) + 2, 3, 3) f32, tri_mats u32, mats
    (2, 28) f32): the pyramid's faces (material 0), then the light's
    two triangles (material 1)."""
    tris = np.empty((4 ** (size_factor + 1) + 2, 3, 3), np.float32)
    tris[:-2] = place(faces(size_factor))
    tris[-2:] = np.asarray(light(), np.float64)
    tm = np.zeros(len(tris), np.uint32)
    tm[-2:] = 1
    mats = np.stack([mat_row(kd=COLOR), mat_row(ke=LIGHT_EMISSION)])
    return tris, tm, mats
