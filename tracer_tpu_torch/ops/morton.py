"""30-bit Morton codes (port of tracer_tpu/ops/morton.py), used by
intersect.build_dense to order triangles."""

from __future__ import annotations

import torch

N_BITS = 30
COMPONENT_BITS = N_BITS // 3
COMPONENT_MAX = float(2 ** COMPONENT_BITS - 1)
_MASK = 0xFFFFFFFF


def expand_bits(x):
    """Spread each of the low 10 bits of x (int64) two positions apart."""
    x = (x * 0x00010001 & _MASK) & 0xFF0000FF
    x = (x * 0x00000101 & _MASK) & 0x0F00F00F
    x = (x * 0x00000011 & _MASK) & 0xC30C30C3
    x = (x * 0x00000005 & _MASK) & 0x49249249
    return x


def morton3d(p):
    """Morton code (int64 in [0, 2^30)) of points (..., 3) inside the unit
    cube; components scale by 2^10 and clamp to 1023, x highest."""
    q = torch.clamp_max(p * (COMPONENT_MAX + 1.0), COMPONENT_MAX)
    q = torch.clamp_min(q, 0.0)
    q = torch.where(torch.isnan(q), 0.0, q)
    xx = expand_bits(q[..., 0].to(torch.int64))
    yy = expand_bits(q[..., 1].to(torch.int64))
    zz = expand_bits(q[..., 2].to(torch.int64))
    return xx * 4 + yy * 2 + zz
