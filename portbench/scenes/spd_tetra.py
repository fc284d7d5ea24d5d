"""The Standard Procedural Databases' `tetra` scene (E. Haines, "A
Proposal for Standard Graphics Environments", IEEE CG&A 7(11), 1987;
tetra.c of github.com/erich666/StandardProceduralDatabases): a
Sierpinski tetrahedron, numpy only.

The root is the regular tetrahedron on the even-parity corners of the
cube [-1, 1]^3. Each level replaces every tetrahedron by four half-size
copies at its corners, SIZE_FACTOR times, so there are 4^SIZE_FACTOR
leaves and 4^(SIZE_FACTOR + 1) faces, each wound outward (its normal
(b - a) x (c - a) points away from its leaf's centroid). Vertices are
computed in float64 and cast to float32 once.

The pyramid is turned by YAW_DEG about y, then PITCH_DEG about x, so
that no face is seen edge-on along the camera's axis and no symmetry
axis lies on it, and its centroid sits CAMERA_DISTANCE in front of
CAMERA_ORIGIN, down -z (the camera of the configuration's pitch and yaw
0). SPD's point light becomes an emissive square of LIGHT_SIDE (2
triangles) up, right and behind the camera, facing the centroid, so the
fractal shadows itself; the API takes triangles only. Every face has one
diffuse material. What is not read from the source is listed under
`assumed` in configs/spd-tetra.json.
"""

import math

import numpy as np

from portbench.reference.scene import mat_row, quad

SIZE_FACTOR = 8
ROOT = np.array([[1.0, 1.0, 1.0], [1.0, -1.0, -1.0], [-1.0, 1.0, -1.0],
                 [-1.0, -1.0, 1.0]])
YAW_DEG, PITCH_DEG = 15.0, -10.0
CAMERA_ORIGIN = (0.0, 0.0, 2.7)
CAMERA_DISTANCE = 2.7
COLOR = (0.8, 0.16, 0.16)
LIGHT_CENTER = (2.5, 3.5, 4.5)
LIGHT_SIDE = 1.0
LIGHT_EMISSION = (80.0, 80.0, 80.0)


def leaves(size_factor: int = SIZE_FACTOR) -> np.ndarray:
    """(4^size_factor, 4, 3) float64 leaf tetrahedra in the root's
    frame: child k of a tetrahedron t has vertices (t_k + t_j) / 2."""
    tets = ROOT[None]
    for _ in range(size_factor):
        tets = 0.5 * (tets[:, :, None, :] + tets[:, None, :, :])
        tets = tets.reshape(-1, 4, 3)
    return tets


def _outward_faces() -> list:
    """Each face of a tetrahedron of ROOT's orientation as vertex
    indices (the face opposite vertex l), ordered so that its normal
    points away from vertex l. Every leaf is a scaled, translated copy
    of the root, so one order serves all."""
    faces = []
    for l in range(4):
        i, j, k = (m for m in range(4) if m != l)
        n = np.cross(ROOT[j] - ROOT[i], ROOT[k] - ROOT[i])
        faces.append((i, j, k) if n @ (ROOT[l] - ROOT[i]) < 0 else (i, k, j))
    return faces


def faces(size_factor: int = SIZE_FACTOR) -> np.ndarray:
    """(4^(size_factor + 1), 3, 3) float64 faces in the root's frame,
    the four faces of each leaf in turn."""
    tets = leaves(size_factor)
    return np.stack([tets[:, list(f)] for f in _outward_faces()],
                    axis=1).reshape(-1, 3, 3)


def rotation() -> np.ndarray:
    """(3, 3) float64: YAW_DEG about y, then PITCH_DEG about x."""
    y, x = math.radians(YAW_DEG), math.radians(PITCH_DEG)
    ry = np.array([[math.cos(y), 0.0, math.sin(y)], [0.0, 1.0, 0.0],
                   [-math.sin(y), 0.0, math.cos(y)]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, math.cos(x), -math.sin(x)],
                   [0.0, math.sin(x), math.cos(x)]])
    return rx @ ry


def centroid() -> np.ndarray:
    return np.asarray(CAMERA_ORIGIN) - np.array([0.0, 0.0, CAMERA_DISTANCE])


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
    tris = faces(size_factor) @ rotation().T + centroid()
    tris = np.concatenate([tris, np.asarray(light(), np.float64)])
    tm = np.zeros(len(tris), np.uint32)
    tm[-2:] = 1
    mats = np.stack([mat_row(kd=COLOR), mat_row(ke=LIGHT_EMISSION)])
    return tris.astype(np.float32), tm, mats
