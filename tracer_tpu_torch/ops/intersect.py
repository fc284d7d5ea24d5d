"""Dense ray-triangle intersection (port of tracer_tpu/ops/intersect.py).

Every determinant of the Moller test is linear in the ray features
phi(ray) = [d, o, o x d, 1], so per triangle four 10-term coefficient
rows (a, n.s, m.e2, m.e1) score any ray with dot products. build_dense
sorts the triangles in morton order, pads them to whole chunks of pad_to
and records each chunk's box; closest_hit / any_hit hand the features to
the kernel wrappers of ops/intersect_kernel.py (the CUDA kernels on the
card, their plain versions on the CPU), and closest_hit recomputes the
winner's t, position and normal exactly from its index.

The port is exact f32 everywhere: the TPU package's bf16 word packing,
ray permutation and Pallas switch are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import morton as morton_mod
from tracer_tpu_torch.ops import shapes

# Chunk padding: small scenes pad to 128, larger ones to 256 triangles.
PAD = 128
PAD_LARGE = 256
PAD_LARGE_MIN_TRIS = 512
# tmax slack of the exact re-test of the winner (intersect.py:481)
REINTERSECT_SLACK = 1e-6


class DenseTris(nn.Module):
    """Precomputed triangle coefficients, as registered buffers.

    coeffs: (4, T_pad, 10) f32 blocks (a, n.s, m.e2, m.e1); columns in
            the order of phi = [d, o, o x d, 1]
    tris:   (T_pad, 10) f32 flattened vertices (9) + an aux scalar
            (column 9: the material id); zero rows are padding
    perm:   (T_pad,) int32, perm[i] = input index of stored triangle i
    chunk_bounds: (n_chunks, 8) f32 per-chunk box [min xyz, max xyz, 0,
            0]; padded chunks carry an inverted (+inf/-inf) box
    """

    def __init__(self, coeffs, tris, perm, chunk_bounds):
        super().__init__()
        self.register_buffer("coeffs", coeffs)
        self.register_buffer("tris", tris)
        self.register_buffer("perm", perm)
        self.register_buffer("chunk_bounds", chunk_bounds)


def default_pad(n_tris: int) -> int:
    return PAD_LARGE if n_tris > PAD_LARGE_MIN_TRIS else PAD


def build_dense(tris, pad_to: int | None = None, aux=None) -> DenseTris:
    """Coefficients of (T, 3, 3) triangles, morton-sorted with a stable
    argsort, padded to whole chunks of pad_to (default: 128, or 256 above
    512 triangles). aux: optional (T,) scalar stored in tris column 9.
    Built on the device of `tris`."""
    tris = torch.as_tensor(tris, dtype=torch.float32).reshape(-1, 3, 3)
    dev = tris.device
    t = tris.shape[0]
    aux = (torch.zeros((t,), device=dev) if aux is None
           else torch.as_tensor(aux, dtype=torch.float32, device=dev).reshape(t))
    if pad_to is None:
        pad_to = default_pad(t)
    if pad_to <= 0:
        raise ValueError(f"pad_to must be positive, got {pad_to}")
    t_pad = max(pad_to, -(-max(t, 1) // pad_to) * pad_to)

    if t > 1:
        tri_min = tris.amin(dim=-2)
        tri_max = tris.amax(dim=-2)
        smin = tri_min.amin(dim=0)
        dims = torch.clamp_min(tri_max.amax(dim=0) - smin, 1e-30)
        centers = ((tri_min + tri_max) * 0.5 - smin) / dims
        order = torch.argsort(morton_mod.morton3d(centers),
                              stable=True).to(torch.int32)
        tris = tris[order.long()]
        aux = aux[order.long()]
    else:
        order = torch.arange(t, dtype=torch.int32, device=dev)

    perm = torch.cat([order, torch.arange(t, t_pad, dtype=torch.int32,
                                          device=dev)])
    tris = torch.cat([tris, torch.zeros((t_pad - t, 3, 3), device=dev)])
    aux = torch.cat([aux, torch.zeros((t_pad - t,), device=dev)])

    n_chunks = t_pad // pad_to
    real = (torch.arange(t_pad, device=dev) < t)[:, None]
    inf = float("inf")
    cmin = torch.where(real, tris.amin(dim=-2), inf)
    cmax = torch.where(real, tris.amax(dim=-2), -inf)
    bmin = cmin.reshape(n_chunks, pad_to, 3).amin(dim=1)
    bmax = cmax.reshape(n_chunks, pad_to, 3).amax(dim=1)
    chunk_bounds = torch.cat(
        [bmin, bmax, torch.zeros((n_chunks, 2), device=dev)], dim=1)

    a_v = tris[:, 0, :]
    e1 = tris[:, 1, :] - a_v
    e2 = tris[:, 2, :] - a_v
    n = la.cross(e1, e2)
    axe1 = la.cross(a_v, e1)
    axe2 = la.cross(a_v, e2)
    zeros = torch.zeros((t_pad, 3), device=dev)
    zero = torch.zeros((t_pad, 1), device=dev)
    coeffs = torch.stack([
        torch.cat([-n, zeros, zeros, zero], dim=-1),                    # a
        torch.cat([zeros, n, zeros,
                   -torch.sum(n * a_v, -1, keepdim=True)], dim=-1),     # n.s
        torch.cat([axe2, zeros, e2, zero], dim=-1),                     # m.e2
        torch.cat([axe1, zeros, e1, zero], dim=-1),                     # m.e1
    ])
    tri_rows = torch.cat([tris.reshape(t_pad, 9), aux[:, None]], dim=1)
    return DenseTris(coeffs=coeffs.contiguous(), tris=tri_rows.contiguous(),
                     perm=perm, chunk_bounds=chunk_bounds.contiguous())


def ray_features_t(origin, d):
    """phi(ray) transposed: (10, N) = [d, o, o x d, 1] rows from V3 rays."""
    n = max(origin.shape[1], d.shape[1])
    origin = origin.expand(3, n)
    d = d.expand(3, n)
    ones = torch.ones((1, n), dtype=torch.float32, device=d.device)
    return torch.cat([d, origin, la.v3_cross(origin, d), ones], dim=0)


def _reintersect(dense: DenseTris, best_i, origin, d, tmax):
    """Exact t, position and normal of the winning triangle, and its aux
    scalar (returned last)."""
    rows_t = dense.tris[best_i.long()].T  # (10, N)
    ok, t, pos, nrm = shapes.hit_triangle_v(tmax, origin, d, rows_t[0:3],
                                            rows_t[3:6], rows_t[6:9])
    return ok, t, pos, nrm, rows_t[9]


def closest_hit(dense: DenseTris, tmax, origin, d):
    """Closest-hit query of V3 rays (3,N) against all triangles.

    Returns (ok (N,), t (N,), tri_idx (N,) int32 in storage order, -1 on
    a miss, pos (3,N), normal (3,N), aux (N,) f32, 0 on a miss)."""
    phi = ray_features_t(origin, d)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    best_t, best_i = ik.closest_hit(dense.coeffs, phi, tmax,
                                    dense.chunk_bounds)
    ok = torch.isfinite(best_t)
    best_i = torch.where(ok, best_i, 0)
    ok2, t, pos, normal, aux = _reintersect(
        dense, best_i, origin, d, tmax * (1.0 + REINTERSECT_SLACK))
    ok = ok & ok2
    return (ok, torch.where(ok, t, float("inf")),
            torch.where(ok, best_i, -1), pos, normal,
            torch.where(ok, aux, 0.0))


def any_hit(dense: DenseTris, tmax, origin, d):
    """Shadow-ray query: True where any triangle is hit before tmax."""
    phi = ray_features_t(origin, d)
    return ik.any_hit(dense.coeffs, phi, tmax, dense.chunk_bounds)


def closest_hit_bruteforce(tris, tmax, origin, d):
    """Pure-broadcast oracle over (N, 3) rays and (T, 3, 3) triangles;
    O(N*T) memory, test-sized inputs only. Returns (hit, best_t,
    best_i in input order, -1 on a miss)."""
    _, t, _, _ = shapes.hit_triangle(tmax, origin[..., None, :],
                                     d[..., None, :], tris)
    best_i = torch.argmin(t, dim=-1).to(torch.int32)
    best_t = t.amin(dim=-1)
    hit = torch.isfinite(best_t)
    return hit, best_t, torch.where(hit, best_i, -1)
