"""ctypes bindings for the native host library (port of
tracer_tpu/utils/native.py).

native/objloader.cpp, the port's own copy of the JAX package's C++ host
library (the OBJ/MTL loader and the ASCII PCD writer behind a C ABI:
tracer_load_obj, tracer_free, tracer_write_pcd), is built with g++ at
first use, never at import, into build/tracer_tpu_torch/ beside the
package. The library's name carries a digest of the compiler flags and
the source; it is written to a temporary file and renamed into place, as
ops/cuda_lib.py does for the kernels, so concurrent first uses do not
clash. When it cannot be built, load_library returns None and load_obj /
write_pcd raise RuntimeError with the compiler's message: nothing here
falls back to the Python loader (utils/objloader.load_obj chooses).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "objloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracer_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtracerhost-{h.hexdigest()[:16]}.so"


@functools.cache
def _load():
    """(library, None, seconds of the build, 0 if it was there) or (None,
    why it could not be built, seconds)."""
    out = library_path()
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
        except OSError as e:
            return None, f"{CXX} could not run: {e}", 0.0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return (None, f"{CXX} failed ({proc.returncode}): {proc.stderr}",
                    time.perf_counter() - t0)
        os.replace(tmp, out)
    secs = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    lib.tracer_load_obj.restype = ctypes.c_int
    lib.tracer_load_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.tracer_free.restype = None
    lib.tracer_free.argtypes = [ctypes.c_void_p]
    lib.tracer_write_pcd.restype = ctypes.c_int
    lib.tracer_write_pcd.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    return lib, None, secs


def load_library(build: bool = True):
    """The native library, built at first use; None if it cannot be built
    (or, with build=False, is not built yet)."""
    if not build and not library_path().exists():
        return None
    return _load()[0]


def build_info() -> dict:
    """Of the first load_library: the library's path, the seconds its
    build took (0.0 when it was already built) and, if it failed, why."""
    lib, why, secs = _load()
    return {"path": lib._name if lib is not None else None,
            "seconds": secs, "error": why}


def available() -> bool:
    return load_library() is not None


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load()[1]}")
    return lib


def load_obj(path: str):
    """Native OBJ/MTL load; returns (tris (T,3,3) f32, tri_mats (T,) u32,
    mats (M,28) f32). Raises RuntimeError on parse errors."""
    lib = _require()
    nt = ctypes.c_size_t()
    nm = ctypes.c_size_t()
    tri_p = ctypes.POINTER(ctypes.c_float)()
    mat_ix_p = ctypes.POINTER(ctypes.c_uint32)()
    mat_p = ctypes.POINTER(ctypes.c_float)()
    err = ctypes.create_string_buffer(512)
    rc = lib.tracer_load_obj(os.fsencode(path), ctypes.byref(nt),
                             ctypes.byref(nm), ctypes.byref(tri_p),
                             ctypes.byref(mat_ix_p), ctypes.byref(mat_p),
                             err, len(err))
    if rc != 0:
        raise RuntimeError(f"native loader: {err.value.decode()}")
    t, m = nt.value, nm.value
    try:
        tris = np.ctypeslib.as_array(tri_p, shape=(t * 9,)).reshape(
            t, 3, 3).copy()
        tri_mats = np.ctypeslib.as_array(mat_ix_p, shape=(t,)).copy()
        mats = np.ctypeslib.as_array(mat_p, shape=(m * 28,)).reshape(
            m, 28).copy()
    finally:
        lib.tracer_free(tri_p)
        lib.tracer_free(mat_ix_p)
        lib.tracer_free(mat_p)
    return tris, tri_mats.astype(np.uint32), mats


def write_pcd(path: str, points) -> None:
    """Native ASCII PCD writer; points (..., 4) [x, y, z, intensity]."""
    lib = _require()
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 4))
    err = ctypes.create_string_buffer(512)
    rc = lib.tracer_write_pcd(
        os.fsencode(path), pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pts.shape[0], err, len(err))
    if rc != 0:
        raise RuntimeError(f"native pcd writer: {err.value.decode()}")
