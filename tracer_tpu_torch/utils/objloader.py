"""OBJ/MTL asset loader, host side (port of tracer_tpu/utils/objloader.py):
the native C++ loader (utils/native.py) when it builds, else this
module's Python loader, numpy only.

Produces the buffers engine/api.py:init consumes:
    tris     f32 (T, 3, 3)   vertex positions per triangle
    tri_mats u32 (T,)        material index per triangle
    mats     f32 (M, 28)     12 color knots | Pr Pm Ni Tf | 12 emission knots

Custom MTL extensions:
    Sp  spectral color: up to 6 (wavelength, intensity) pairs
    Em  spectral emission, same encoding
    Pr  roughness (default 1.0)     Pm  metalness (default 0.0)
    Tf  opacity (default 1.0)       Ni  refractive index (default 1.0)
Fallback when Sp/Em are absent: RGB Kd/Ke mapped to knots at
610/550/460 nm.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from tracer_tpu_torch.utils import native

RED_WAVELEN = 610.0
GREEN_WAVELEN = 550.0
BLUE_WAVELEN = 460.0


@dataclass
class _Mtl:
    name: str
    kd: tuple = (0.0, 0.0, 0.0)
    ke: tuple = (0.0, 0.0, 0.0)
    ni: float = 1.0
    extras: dict = field(default_factory=dict)  # Sp/Em/Pr/Pm/Tf raw strings


def _parse_floats(s: str):
    return [float(t) for t in s.split()]


def _lines(path: str):
    """(tag, rest) of each non-empty line, comments stripped."""
    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if line:
                parts = line.split(None, 1)
                yield parts[0], parts[1].strip() if len(parts) > 1 else ""


def parse_mtl(path: str) -> list[_Mtl]:
    """Parse a .mtl file keeping material declaration order (which defines
    the material indices)."""
    mats: list[_Mtl] = []
    cur: _Mtl | None = None
    for tag, rest in _lines(path):
        if tag == "newmtl":
            cur = _Mtl(name=rest)
            mats.append(cur)
        elif cur is None:
            continue
        elif tag == "Kd":
            cur.kd = tuple(_parse_floats(rest)[:3])
        elif tag == "Ke":
            cur.ke = tuple(_parse_floats(rest)[:3])
        elif tag == "Ni":
            cur.ni = _parse_floats(rest)[0]
        elif tag in ("Sp", "Em", "Pr", "Pm", "Tf"):
            cur.extras[tag] = rest
    return mats


def _spectrum12(raw: str | None, rgb_fallback) -> list[float]:
    """Encode a spectrum as 12 floats: Sp/Em pairs padded with (-1, 0), or
    the RGB fallback at the three reference wavelengths."""
    if raw is not None:
        return (_parse_floats(raw) + [-1.0, 0.0] * 6)[:12]
    r, g, b = rgb_fallback
    return [RED_WAVELEN, r, GREEN_WAVELEN, g, BLUE_WAVELEN, b,
            -1.0, 0.0, -1.0, 0.0, -1.0, 0.0]


def _mat_row(m: _Mtl) -> np.ndarray:
    color = _spectrum12(m.extras.get("Sp"), m.kd)
    emission = _spectrum12(m.extras.get("Em"), m.ke)
    roughness = float(m.extras["Pr"]) if "Pr" in m.extras else 1.0
    metalness = float(m.extras["Pm"]) if "Pm" in m.extras else 0.0
    opacity = (float(_parse_floats(m.extras["Tf"])[0])
               if "Tf" in m.extras else 1.0)
    row = color + [roughness, metalness, m.ni, opacity] + emission
    return np.asarray(row, np.float32)


def load_obj(path: str, backend: str = "auto"):
    """Load an OBJ with its MTL. Returns (tris (T,3,3) f32,
    tri_mats (T,) u32, mats (M,28) f32); polygons are fan-triangulated.

    backend: "auto" prefers the native loader (utils/native.py), as the
    JAX twin does; where the native library cannot be built, or refuses
    the file, the Python loader reads it (and raises ValueError naming
    what is wrong with it). "native" raises RuntimeError instead, and
    "python" is this module's loader alone."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "python":
        if backend == "native":
            return native.load_obj(path)
        if native.available():
            try:
                return native.load_obj(path)
            except RuntimeError:
                pass   # the Python loader says what is wrong
    return _load_obj_py(path)


def _load_obj_py(path: str):
    """The Python loader."""
    vertices: list[list[float]] = []
    tris: list[list[list[float]]] = []
    tri_mats: list[int] = []
    mtls: list[_Mtl] = []
    mat_index: dict[str, int] = {}
    cur_mat: int | None = None
    base = os.path.dirname(os.path.abspath(path))

    for tag, rest in _lines(path):
        if tag == "v":
            vertices.append(_parse_floats(rest)[:3])
        elif tag == "mtllib":
            mtls = parse_mtl(os.path.join(base, rest))
            mat_index = {m.name: i for i, m in enumerate(mtls)}
        elif tag == "usemtl":
            if rest not in mat_index:
                raise ValueError(f"unknown material {rest!r} in {path}")
            cur_mat = mat_index[rest]
        elif tag == "f":
            idxs = []
            for tok in rest.split():
                i = int(tok.split("/")[0])
                idxs.append(i - 1 if i > 0 else len(vertices) + i)
            if cur_mat is None:
                raise ValueError(f"face without material in {path}")
            for k in range(1, len(idxs) - 1):
                tris.append([vertices[idxs[0]], vertices[idxs[k]],
                             vertices[idxs[k + 1]]])
                tri_mats.append(cur_mat)

    tris_np = np.asarray(tris, np.float32).reshape(-1, 3, 3)
    tri_mats_np = np.asarray(tri_mats, np.uint32)
    mats_np = (np.stack([_mat_row(m) for m in mtls])
               if mtls else np.zeros((0, 28), np.float32))
    return tris_np, tri_mats_np, mats_np
