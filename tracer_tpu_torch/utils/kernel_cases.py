"""Inputs and a tolerance oracle for holding the intersection kernels
(ops/intersect_kernel.py) to their plain versions and to the JAX package.
Used by tests/test_torch_intersect.py and chip_smoke.py.

  random_case         seeded random triangles and rays (numpy)
  on_plane_rays       axis-parallel rays whose origins lie on chunk bounds
  cornell_plane_rays  rays on the Cornell box's bound planes
  boundary_lanes      lanes where two f32 evaluations may rightly differ
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_tpu_torch.ops import shapes


def random_case(n_tris: int, n_rays: int):
    """(tris (n_tris, 3, 3), o (n_rays, 3), d (n_rays, 3)) f32: triangles
    uniform in [-2, 2]^3, origins in [-3, 3]^3, unit directions; seeded
    with n_tris."""
    r = np.random.default_rng(n_tris)
    tris = r.uniform(-2, 2, (n_tris, 3, 3)).astype(np.float32)
    o = r.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tris, o, d


def on_plane_rays(bounds):
    """Axis-parallel rays whose origins lie exactly on the bound planes of
    each non-empty chunk (bounds (n_chunks, 8) numpy): on its min-x
    plane, its max-y plane, its max-x/min-y edge (going +z) and its
    min-x/min-y edge. Returns (o (k, 3), d (k, 3)) f32."""
    o, d = [], []
    for b in bounds:
        if not b[0] <= b[3]:
            continue
        cy, cx = 0.5 * (b[1] + b[4]), 0.5 * (b[0] + b[3])
        o += [[b[0], cy, 4.0], [cx, b[4], 4.0], [b[3], b[1], -4.0],
              [b[0], b[1], 4.0]]
        d += [[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0],
              [0.0, 0.0, -1.0]]
    return np.asarray(o, np.float32), np.asarray(d, np.float32)


def cornell_plane_rays():
    """Rays on the bound planes of the Cornell box of
    utils/testscenes.cornell_like (its one chunk's box is the box itself),
    parallel to that plane, hitting walls at exactly representable
    points. Returns (o (5, 3), d (5, 3)) f32."""
    o = np.asarray([[-1.0, 1.0, 0.5], [0.5, 0.0, 0.5], [1.0, 1.5, 0.5],
                    [-1.0, 0.5, 0.5], [0.25, 2.0, 0.5]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0],
                    [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
    return o, d


def _boundary_block(rows, c, phi64, tm, rel):
    n = phi64.shape[1]
    inf = float("inf")
    edge = torch.zeros((n,), dtype=torch.bool, device=phi64.device)
    top2 = torch.full((2, n), inf, dtype=torch.float64, device=phi64.device)
    for r in rows:
        p = r @ phi64
        a, nt, nu, nv = p[:c], p[c:2 * c], p[2 * c:3 * c], p[3 * c:]
        aa = torch.abs(a)
        inv_a = 1.0 / torch.where(a == 0, 1.0, a)
        t, u, v = nt * inv_a, nu * inv_a, -nv * inv_a
        tol_t = rel * torch.clamp_min(torch.abs(t), 1.0)

        def tests(s):  # s = +1 loosens every test, -1 tightens it
            return ((aa >= shapes.TRI_EPS * (1 - s * rel))
                    & (u >= -s * rel) & (v >= -s * rel)
                    & (u + v <= 1 + s * rel)
                    & (t > -s * tol_t) & (t < tm + s * tol_t))

        loose = tests(1.0)
        edge |= (loose & ~tests(-1.0)).any(dim=0)
        cand = torch.where(loose, t, inf)
        top2 = torch.topk(torch.cat([top2, cand]), 2, dim=0,
                          largest=False).values
    tie = (torch.isfinite(top2[1])
           & (top2[1] - top2[0] <= rel * torch.abs(top2[0])))
    return edge, tie


def boundary_lanes(coeffs, phi, tmax, chunk_bounds, rel: float = 1e-5,
                   block: int = 65536):
    """Lanes whose results may rightly differ between two f32 evaluations
    that sum in another order, computed in float64 over every triangle,
    `block` lanes at a time.

    Operands as ops/intersect_kernel.py:closest_hit takes them. Returns
    (edge (N,), tie (N,)): edge where some triangle's validity flips when
    each of its tests (|a| >= TRI_EPS, u >= 0, v >= 0, u + v <= 1, t > 0,
    t < tmax) moves by `rel`; tie where the two smallest candidate t's lie
    within `rel` of each other."""
    n = phi.shape[1]
    c = coeffs.shape[1] // chunk_bounds.shape[0]
    rows = [coeffs[:, ci * c:(ci + 1) * c].reshape(4 * c, 10).double()
            for ci in range(chunk_bounds.shape[0])]
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=phi.device).double().expand(n)
    parts = [_boundary_block(rows, c, phi[:, i:i + block].double(),
                             tmax[i:i + block], rel)
             for i in range(0, n, block)]
    return (torch.cat([e for e, _ in parts]),
            torch.cat([t for _, t in parts]))
