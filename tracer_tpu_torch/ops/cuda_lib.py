"""Build and load the hand-written kernels of csrc/ as one shared library.

Every CUDA source under csrc/ (intersect.cu: K1-K4 and their exact
yardstick, recip.cu: K5, shade.cu: K6-K7, prep.cu: K8-K12, a sorted
query's preparation) goes to
one nvcc call, at first use, into build/tracer_tpu_torch/ beside the
package, keyed on a hash of the flags and of every source; the library
is loaded with ctypes and each kernel's wrapper module declares the
argument types of its entry points. Nothing is built when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class _Built:
    lib: ctypes.CDLL | None = None
    seconds: float = 0.0
    log: str = ""


def sources() -> list[Path]:
    """The CUDA sources, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build tracer_tpu_torch/csrc/")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found under {CUDA_HOME}")
    return str(nvcc)


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def load() -> ctypes.CDLL:
    """Compile every csrc/*.cu into one library (once per hash of the
    sources) and load it. nvcc's log, with each kernel's registers, shared
    memory and spills (-Xptxas -v), is kept in build_info()."""
    if _Built.lib is not None:
        return _Built.lib
    out = BUILD_DIR / f"libtracer_kernels-{_sources_digest()[:16]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _Built.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{_Built.log}")
        os.replace(tmp, out)
    _Built.lib = ctypes.CDLL(str(out))
    _Built.seconds = time.perf_counter() - t0
    return _Built.lib


def build_info() -> dict:
    """Seconds the last load() took (0 before it ran), nvcc's log, the
    sources it compiled and the library's path (None before it ran)."""
    return {"seconds": _Built.seconds, "log": _Built.log,
            "sources": [p.name for p in sources()],
            "path": None if _Built.lib is None else _Built.lib._name}


def kernel_resources(log: str | None = None) -> dict:
    """What ptxas -v said of each kernel in the last build's log (or in
    `log`): {mangled entry name: {"registers", "spill_stores",
    "spill_loads"}} (bytes of spills per thread). Empty when load() found
    the library already built."""
    out, cur = {}, None
    for line in (_Built.log if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device `index`, for
    a kernel's launch, without building a torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)
