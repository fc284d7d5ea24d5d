"""The one seam between the port and its hand kernels: every CUDA source
under csrc/ (intersect.cu: K1-K4 and their exact yardstick, recip.cu: K5,
shade.cu: K6-K7, prep.cu: K8-K12, refill.cu: K13, bvh.cu: K14-K15,
interaction.cu: K16) built by one nvcc call at first use, into
build/tracer_tpu_torch/ keyed on a hash of the flags and sources (and of
the headers they include), loaded with ctypes,
launched, checked and counted. Nothing is built when a module is
imported.

Every kernel's host entry point has one form, int <name>_launch(const
void* const* ptr, const long long* in, int n_ptr, int n_int, void*
stream): its operands' pointers and its integers (a float as its IEEE
bits), checking its own arity, returning 0 or a cudaError_t. A wrapper
checks each operand with operand(), launches with launch() and counts a
call of its plain version with plain(); its copies of constants of csrc/
are registered with expect() and checked at load.
"""

from __future__ import annotations

import contextlib
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

# Every kernel, by the name it is counted under: K1-K4 and their yardstick
# (intersect.cu; K2 and K4 launch through closest_hit_launch and
# any_hit_launch), K8-K12 (prep.cu), K6/K7 (shade.cu), K13 (refill.cu),
# K14/K15 (bvh.cu), K16 (interaction.cu) and K5 (recip.cu).
KERNELS = ("closest_hit", "closest_hit_streamed", "any_hit",
           "any_hit_streamed", "closest_hit_exact", "lane_key", "lane_deal",
           "superchunk", "schedule", "heavy_first", "shade_prepare",
           "shade_finish", "refill", "lbvh_closest", "lbvh_any",
           "interaction", "approx_reciprocal")
# Launches of each kernel and calls of each one's plain version where a
# wrapper dispatches; launch() and plain() add to them and nothing else.
launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)


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
    lib = ctypes.CDLL(str(out))
    _check_constants(lib)
    _Built.lib = lib
    _Built.seconds = time.perf_counter() - t0
    return lib


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


def reset_counts() -> None:
    """Set every kernel's launch and plain-call count to 0."""
    for k in KERNELS:
        launches[k] = 0
        plain_calls[k] = 0


def plain(name: str) -> None:
    """Count one call of kernel `name`'s plain version."""
    plain_calls[name] += 1


# {getter of csrc/: the value a wrapper holds}
_expected: dict[str, int] = {}


def _check_constants(lib) -> None:
    for getter, want in _expected.items():
        if getattr(lib, getter)() != want:
            raise RuntimeError(f"csrc/ {getter}() is {getattr(lib, getter)()}"
                               f", the wrapper's {want}")


def expect(**values: int) -> None:
    """Register a wrapper's copies of constants of csrc/, by the name of
    the int() getter that returns each: the library is checked against
    them at load (now, if it is loaded already)."""
    _expected.update(values)
    if _Built.lib is not None:
        _check_constants(_Built.lib)


def operand(x, device, dtype=torch.float32, shape=None, strided=False):
    """x, after checking its device, dtype and shape (None: any), and
    that it is contiguous unless the kernel takes its strides."""
    if x.device != device or x.dtype != dtype or (
            shape is not None and tuple(x.shape) != tuple(shape)):
        raise ValueError(f"operand of {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, want {shape} {dtype} on {device}")
    if not (strided or x.is_contiguous()):
        raise ValueError(f"operand of {tuple(x.shape)} {x.dtype} must be "
                         f"contiguous")
    return x


class Launch:
    """One launch's entry point and arguments, its tensors held: calling
    it queues the same launch again on the stream it was made on, not
    counted (a kernel timed alone)."""

    def __init__(self, name: str, entry: str, device, ptrs, ints):
        self.name, self.held = name, tuple(ptrs)
        self._fn = getattr(load(), entry)   # returns int, the default
        self._args = (
            (ctypes.c_void_p * len(ptrs))(
                *(None if x is None else x.data_ptr() for x in ptrs)),
            (ctypes.c_longlong * len(ints))(*ints), len(ptrs), len(ints),
            ctypes.c_void_p(raw_stream(device.index)))

    def __call__(self) -> None:
        err = self._fn(*self._args)
        if err:
            raise RuntimeError(f"{self.name}_kernel launch failed: CUDA "
                               f"error {err}")


_recorded: list | None = None


@contextlib.contextmanager
def recording():
    """Within the block, every launch() also appends its Launch to the
    list this yields."""
    global _recorded
    kept, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = kept


def launch(name: str, device, ptrs, ints, entry: str | None = None) -> None:
    """Launch kernel `name` (of KERNELS) through its entry point (entry,
    by default <name>_launch) on torch's current stream of `device`: ptrs
    are tensors (or None, a null pointer), ints python ints, passed as
    int64. Raises on an error; counts the launch."""
    call = Launch(name, entry or f"{name}_launch", device, ptrs, ints)
    call()
    launches[name] += 1
    if _recorded is not None:
        _recorded.append(call)
