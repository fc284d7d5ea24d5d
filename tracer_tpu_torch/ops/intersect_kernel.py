"""Wrappers of the hand-written intersection kernels (csrc/intersect.cu)
and their plain PyTorch versions.

  closest_hit(coeffs, phi, tmax, chunk_bounds) -> (best_t, best_i)
      replaces tracer_tpu/ops/pallas/intersect_kernel.py:closest_hit_pallas
  any_hit(coeffs, phi, tmax, chunk_bounds) -> hit
      replaces tracer_tpu/ops/pallas/intersect_kernel.py:any_hit_pallas

coeffs (4, T_pad, 10) f32 and chunk_bounds (n_chunks, 8) f32 come from
intersect.build_dense; phi (10, N) f32 is intersect.ray_features_t; tmax
is a scalar or (N,). best_t is +inf and best_i 0 on a miss, best_i in
storage order.

Dispatch: a tensor on the CPU goes to the plain version (closest_hit_ref,
any_hit_ref, the chunked exact-f32 form of tracer_tpu/ops/intersect.py);
a CUDA tensor launches the kernel or raises. The kernels are built with
nvcc at first use into build/tracer_tpu_torch/ beside the package,
keyed on a hash of the source, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from tracer_tpu_torch.ops import shapes

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "intersect.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# 4 * chunk_t * 10 f32 coefficients must fit the 48 KB of static-size
# shared memory a block gets without an opt-in.
MAX_CHUNK_T = (48 * 1024) // (4 * 10 * 4)

# Launches of each kernel, and calls of each plain version. A wrapper adds
# one where it launches its kernel (or runs its plain version) and
# nowhere else; reset_counts() sets all to 0.
launches = {"closest_hit": 0, "any_hit": 0}
plain_calls = {"closest_hit": 0, "any_hit": 0}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0
        plain_calls[k] = 0


# ---------------------------------------------------------------------------
# Build and load

class _Built:
    lib: ctypes.CDLL | None = None
    seconds: float = 0.0
    log: str = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build tracer_tpu_torch/csrc/intersect.cu")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found under {CUDA_HOME}")
    return str(nvcc)


def build() -> ctypes.CDLL:
    """Compile csrc/intersect.cu (once per source hash) and load it.

    nvcc's log, with each kernel's registers, shared memory and spills
    (-Xptxas -v), is kept in build_info()."""
    if _Built.lib is not None:
        return _Built.lib
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libintersect-{digest[:16]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _Built.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{_Built.log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    ptrs = [ctypes.c_void_p] * 4
    ints = [ctypes.c_int] * 4
    lib.closest_hit_launch.argtypes = ptrs + ints + [ctypes.c_void_p] * 3
    lib.closest_hit_launch.restype = ctypes.c_int
    lib.any_hit_launch.argtypes = ptrs + ints + [ctypes.c_void_p] * 2
    lib.any_hit_launch.restype = ctypes.c_int
    _Built.seconds = time.perf_counter() - t0
    _Built.lib = lib
    return lib


def build_info() -> dict:
    """Seconds the last build() took (0 before it ran) and nvcc's log."""
    return {"seconds": _Built.seconds, "log": _Built.log}


# ---------------------------------------------------------------------------
# Argument checks

def _check(coeffs, phi, tmax, chunk_bounds):
    """Validate the operands; returns (tmax as (N,) f32, n_chunks,
    chunk_t)."""
    if phi.dim() != 2 or phi.shape[0] != 10:
        raise ValueError(f"phi must be (10, N), got {tuple(phi.shape)}")
    n = phi.shape[1]
    if coeffs.dim() != 3 or coeffs.shape[0] != 4 or coeffs.shape[2] != 10:
        raise ValueError(f"coeffs must be (4, T_pad, 10), got "
                         f"{tuple(coeffs.shape)}")
    if chunk_bounds.dim() != 2 or chunk_bounds.shape[1] != 8:
        raise ValueError(f"chunk_bounds must be (n_chunks, 8), got "
                         f"{tuple(chunk_bounds.shape)}")
    n_chunks = chunk_bounds.shape[0]
    t_pad = coeffs.shape[1]
    if n_chunks == 0 or t_pad % n_chunks:
        raise ValueError(f"{t_pad} padded triangles do not split into "
                         f"{n_chunks} chunks")
    for name, x in (("coeffs", coeffs), ("phi", phi),
                    ("chunk_bounds", chunk_bounds)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != phi.device:
            raise ValueError(f"{name} is on {x.device}, phi on {phi.device}")
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    if tmax.dim() == 0:
        tmax = tmax.expand(n)
    if tmax.shape != (n,):
        raise ValueError(f"tmax must be a scalar or ({n},), got "
                         f"{tuple(tmax.shape)}")
    return tmax, n_chunks, t_pad // n_chunks


def _cuda_operands(coeffs, phi, tmax, chunk_bounds, chunk_t):
    if chunk_t > MAX_CHUNK_T:
        raise ValueError(f"chunk of {chunk_t} triangles exceeds the "
                         f"kernel's {MAX_CHUNK_T}")
    for name, x in (("coeffs", coeffs), ("phi", phi),
                    ("chunk_bounds", chunk_bounds)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if phi.shape[1] >= 2 ** 31:
        raise ValueError("too many rays for int32 lane ids")
    return tmax.contiguous()


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# Plain versions

def _chunk_scores(rows, phi, tmax, c: int):
    """rows (4C, 10) @ phi (10, N) -> (valid (C, N), t (C, N), +inf where
    invalid): the exact divide form of intersect.py:_chunk_scores_t."""
    p = rows @ phi
    a, nt, nu, nv = p[:c], p[c:2 * c], p[2 * c:3 * c], p[3 * c:]
    nondeg = torch.abs(a) >= shapes.TRI_EPS
    inv_a = nondeg.to(torch.float32) / torch.where(nondeg, a, 1.0)
    t = nt * inv_a
    u = nu * inv_a
    v = -nv * inv_a
    valid = nondeg & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < tmax)
    return valid, torch.where(valid, t, float("inf"))


def _chunk_rows(coeffs, ci: int, chunk_t: int):
    return coeffs[:, ci * chunk_t:(ci + 1) * chunk_t].reshape(4 * chunk_t, 10)


def closest_hit_ref(coeffs, phi, tmax, chunk_bounds):
    """Plain version of the closest-hit kernel: per chunk the min t and its
    first argmin, merged with a strict <, so ties keep the lowest index."""
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    plain_calls["closest_hit"] += 1
    n = phi.shape[1]
    best_t = torch.full((n,), float("inf"), device=phi.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=phi.device)
    for ci in range(n_chunks):
        _, t = _chunk_scores(_chunk_rows(coeffs, ci, chunk_t), phi, tmax,
                             chunk_t)
        loc_i = torch.argmin(t, dim=0)
        loc_t = torch.gather(t, 0, loc_i[None])[0]
        better = loc_t < best_t
        best_t = torch.where(better, loc_t, best_t)
        best_i = torch.where(better, (loc_i + ci * chunk_t).to(torch.int32),
                             best_i)
    return best_t, best_i


def any_hit_ref(coeffs, phi, tmax, chunk_bounds):
    """Plain version of the any-hit kernel: OR over chunks."""
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    plain_calls["any_hit"] += 1
    hit = torch.zeros((phi.shape[1],), dtype=torch.bool, device=phi.device)
    for ci in range(n_chunks):
        valid, _ = _chunk_scores(_chunk_rows(coeffs, ci, chunk_t), phi, tmax,
                                 chunk_t)
        hit |= valid.any(dim=0)
    return hit


# ---------------------------------------------------------------------------
# Dispatching wrappers

def closest_hit(coeffs, phi, tmax, chunk_bounds):
    """Closest hit per ray: (best_t (N,) f32, best_i (N,) int32)."""
    if phi.device.type == "cpu":
        return closest_hit_ref(coeffs, phi, tmax, chunk_bounds)
    if phi.device.type != "cuda":
        raise ValueError(f"no intersection kernel for {phi.device}")
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    tmax = _cuda_operands(coeffs, phi, tmax, chunk_bounds, chunk_t)
    n = phi.shape[1]
    best_t = torch.empty((n,), dtype=torch.float32, device=phi.device)
    best_i = torch.empty((n,), dtype=torch.int32, device=phi.device)
    if n == 0:
        return best_t, best_i
    err = build().closest_hit_launch(
        _ptr(coeffs), _ptr(phi), _ptr(tmax), _ptr(chunk_bounds), n,
        coeffs.shape[1], n_chunks, chunk_t, _ptr(best_t), _ptr(best_i),
        _stream(phi.device))
    if err:
        raise RuntimeError(f"closest_hit_kernel launch failed: CUDA error {err}")
    launches["closest_hit"] += 1
    return best_t, best_i


def any_hit(coeffs, phi, tmax, chunk_bounds):
    """Whether any triangle is hit before tmax, per ray: (N,) bool."""
    if phi.device.type == "cpu":
        return any_hit_ref(coeffs, phi, tmax, chunk_bounds)
    if phi.device.type != "cuda":
        raise ValueError(f"no intersection kernel for {phi.device}")
    tmax, n_chunks, chunk_t = _check(coeffs, phi, tmax, chunk_bounds)
    tmax = _cuda_operands(coeffs, phi, tmax, chunk_bounds, chunk_t)
    n = phi.shape[1]
    hit = torch.empty((n,), dtype=torch.bool, device=phi.device)
    if n == 0:
        return hit
    err = build().any_hit_launch(
        _ptr(coeffs), _ptr(phi), _ptr(tmax), _ptr(chunk_bounds), n,
        coeffs.shape[1], n_chunks, chunk_t, _ptr(hit), _stream(phi.device))
    if err:
        raise RuntimeError(f"any_hit_kernel launch failed: CUDA error {err}")
    launches["any_hit"] += 1
    return hit
