"""Vector math on batched tensors (port of tracer_tpu/ops/linalg.py).

Two conventions, as in the JAX package: (..., 3) vectors with a trailing
component axis for host-side and build-time code, and transposed
V3 = (3, N) vectors with the component axis first on the render path.
The public functions of the ported modules keep V3 so the tests compare
lane for lane with the JAX twin.
"""

from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi


def vec3(x, y, z):
    """Stack components along a new last axis."""
    x, y, z = torch.broadcast_tensors(*(torch.as_tensor(c, dtype=torch.float32)
                                        for c in (x, y, z)))
    return torch.stack([x, y, z], dim=-1)


def dot(a, b):
    """Batched dot product over the trailing component axis."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def norm(a):
    return torch.sqrt(dot(a, a))


def normalize(a, eps: float = 0.0):
    """Unit vector. With eps=0, 0/0 -> nan for degenerate inputs, as the
    reference."""
    n = norm(a)
    if eps:
        n = torch.clamp_min(n, eps)
    return a / n[..., None]


def lerp(a, b, r):
    """f32.lerp semantics: a + r*(b-a)."""
    return a + r * (b - a)


# ---------------------------------------------------------------------------
# Transposed vectors: V3 = (3, N).

def v3(x, y, z):
    """Stack (N,) components into a (3, N) vector."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=0)


def v3_const(x, y, z, device=None):
    """A constant vector as (3, 1), broadcasting against (3, N). Made by
    fills, not from a host list: a program captured by torch.export holds
    no tensor constant inside its loops."""
    return torch.stack([torch.full((1,), float(c), dtype=torch.float32,
                                   device=device) for c in (x, y, z)])


def v3_dot(a, b):
    p = a * b
    return p[0] + p[1] + p[2]


def v3_cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]], dim=0)


def v3_quadrance(a):
    return v3_dot(a, a)


def v3_norm(a):
    return torch.sqrt(v3_quadrance(a))


def v3_normalize(a, eps: float = 0.0):
    q = v3_quadrance(a)
    if eps:
        q = torch.clamp_min(q, eps * eps)
    return a * torch.rsqrt(q)


def v3_same_side(dominant, w):
    return torch.sign(v3_dot(dominant, w)) * w


def v3_from_array(arr):
    """(..., 3) -> (3, ...)."""
    return torch.movedim(torch.as_tensor(arr, dtype=torch.float32), -1, 0)


def v3_to_array(v):
    """(3, ...) -> (..., 3)."""
    return torch.movedim(v, 0, -1)
