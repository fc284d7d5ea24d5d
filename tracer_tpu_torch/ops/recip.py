"""Wrapper of the approximate-reciprocal kernel (csrc/recip.cu, K5) and its
plain version.

  approx_reciprocal(x) -> y, |y - 1/x| <= RCP_APPROX_REL |1/x|
      replaces benchmarks/measure_recip.py:_kernel, the JAX package's
      probe of pl.reciprocal(approx=True), the instruction its closest-hit
      kernel uses on the TPU by default

The kernel issues Hopper's approximate reciprocal (rcp.approx.ftz.f32,
the MUFU unit) per element, four to a 16-byte access. It is bound by
bytes: 4 B read and 4 B written per element against one special-function
op, so its bound is 8 B x n over the card's memory rate. What it is for
is the error of the instruction, which utils/measure_recip.py measures.

Dispatch: x must be float32. A tensor on the CPU goes to the plain
version approx_reciprocal_ref, torch.reciprocal, the function the kernel
approximates; a contiguous CUDA tensor of any length and offset launches
the kernel; anything else raises. The output is allocated at x's offset
from a 16-byte boundary, so that the kernel's float4 body covers both.
The kernel is built with the others by ops/cuda_lib.py at first use; a
call on the card is the checks, one allocation and the ctypes launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_tpu_torch.ops import cuda_lib

# Relative error bound of the approximate reciprocal: the port's copy of
# tracer_tpu/ops/pallas/intersect_kernel.py APPROX_RECIP_REL, the bound
# the JAX package's _reintersect slack is sized for.
APPROX_RECIP_REL = 2.0 ** -8
# What the kernel itself is held to: the PTX ISA bounds rcp.approx.f32 by
# 1 ulp over the full range, at most 2^-23 relative, and the plain
# version's rounding adds at most 2^-24. A reciprocal of a bf16-rounded
# input (about 2^-9) or any coarser approximation fails it.
RCP_APPROX_REL = 2.0 ** -22

NAME = "approx_reciprocal"
# Kernel launches and plain-version calls; a wrapper adds one where it
# launches the kernel (or runs the plain version) and nowhere else.
launches = {NAME: 0}
plain_calls = {NAME: 0}


def reset_counts() -> None:
    launches[NAME] = 0
    plain_calls[NAME] = 0


@functools.cache
def build() -> ctypes.CDLL:
    """The kernels' library with K5's entry point declared."""
    lib = cuda_lib.load()
    lib.approx_reciprocal_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.approx_reciprocal_launch.restype = ctypes.c_int
    return lib


def approx_reciprocal_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the exactly rounded f32 reciprocal."""
    return torch.reciprocal(x)


def approx_reciprocal(x: torch.Tensor) -> torch.Tensor:
    """Elementwise approximate 1/x of a float32 tensor, same shape."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.device.type == "cpu":
        plain_calls[NAME] += 1
        return approx_reciprocal_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no approximate-reciprocal kernel for {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.numel()
    skew = (x.data_ptr() >> 2) & 3  # floats past x's 16-byte boundary
    if skew:
        y = torch.empty(n + skew, dtype=x.dtype, device=x.device)[skew:]
        y = y.view(x.shape)
    else:
        y = torch.empty_like(x)
    if n:
        err = build().approx_reciprocal_launch(
            x.data_ptr(), y.data_ptr(), n, cuda_lib.raw_stream(x.device.index))
        if err:
            raise RuntimeError(f"approx_reciprocal_kernel launch failed: "
                               f"CUDA error {err}")
        launches[NAME] += 1
    return y
