"""Light types and incident radiance (port of tracer_tpu/models/lights.py).

A fixed-size SoA table with an int32 kind per slot, so one lane per ray
evaluates any light type branch-free.
"""

from __future__ import annotations

import torch
from torch import nn

from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import spectrum as spec

KIND_POINT = 0
KIND_DIFFUSE_AREA = 1
KIND_FRUSTUM_AREA = 2


class Lights(nn.Module):
    """SoA light table. For point lights tri[:, 0] holds the position;
    for area lights tri is the emitting triangle."""

    def __init__(self, kind, tri, theta, emission):
        super().__init__()
        self.register_buffer("kind", torch.as_tensor(kind, dtype=torch.int32))
        self.register_buffer("tri", torch.as_tensor(tri, dtype=torch.float32))
        self.register_buffer("theta",
                             torch.as_tensor(theta, dtype=torch.float32))
        self.register_buffer("emission",
                             torch.as_tensor(emission, dtype=torch.float32))

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def empty_lights() -> Lights:
    return Lights(kind=torch.zeros((0,), dtype=torch.int32),
                  tri=torch.zeros((0, 3, 3)), theta=torch.zeros((0,)),
                  emission=torch.zeros((0, 6, 2)))


def area_incident_radiance(kind, tri, theta, emission, hitp, lightp,
                           wavelen):
    """Kind-dispatched area-light radiance, (..., 3) layout with (N,)
    kinds, (N, 3, 3) triangles, (N,) theta and a (6, 2) or per-lane
    (N, 6, 2) emission spectrum."""
    v = lightp - hitp
    wi = la.normalize(v, eps=1e-30)
    dist_sq = la.dot(v, v)
    lnormal = la.normalize(la.cross(tri[..., 1, :] - tri[..., 0, :],
                                    tri[..., 2, :] - tri[..., 0, :]))
    cos_theta_l = la.dot(-wi, lnormal)
    em = spec.lookup_pairs(wavelen, [(emission[..., k, 0], emission[..., k, 1])
                                     for k in range(emission.shape[-2])])
    diffuse = torch.clamp_min(em * cos_theta_l / dist_sq, 0.0)
    inside = torch.arccos(torch.clamp(cos_theta_l, -1.0, 1.0)) <= theta
    frustum = torch.where(inside, em / dist_sq, 0.0)
    return torch.where(kind == KIND_FRUSTUM_AREA, frustum, diffuse)
