"""Inputs and a tolerance oracle for holding the intersection kernels
(ops/intersect_kernel.py) to their plain versions and to the JAX package.
Used by tests/test_torch_intersect.py and chip_smoke.py.

  random_case         seeded random triangles and rays (numpy)
  bigscene_rays       coherent and incoherent rays over a big scene
  render_rays         camera, first-bounce and shadow rays of a state
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


def bigscene_rays(tris, n: int, seed: int):
    """The rays of benchmarks/bigscene_check.py:make_rays, drawn in the
    same order from np.random.default_rng(seed): the first n // 2 are
    coherent, from an eye behind and above the scene's box towards a
    jittered grid on the box's mid plane (jittered so that no ray lands
    exactly on a shared edge of a subdivided mesh); the rest are
    incoherent, with origins spread over 1.4x the box and random
    directions. Returns (o (n, 3), d (n, 3)) f32, unit directions."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(tris, np.float32).reshape(-1, 3)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    c = (lo + hi) * 0.5
    r = float(np.max(hi - lo))

    n_coh = n // 2
    eye = c + np.array([0.0, 0.35 * r, 1.6 * r], np.float32)
    side = int(np.sqrt(n_coh))
    u = ((np.arange(n_coh) % side) + rng.random(n_coh)) / side - 0.5
    v = ((np.arange(n_coh) // side) + rng.random(n_coh)) / side - 0.5
    tgt = c[None, :] + np.stack([u, v, np.zeros_like(u)], axis=1) * r
    d_coh = tgt - eye[None, :]
    o_coh = np.broadcast_to(eye, (n_coh, 3))

    n_inc = n - n_coh
    o_inc = c + (rng.random((n_inc, 3), np.float32) - 0.5) * 1.4 * r
    d_inc = rng.standard_normal((n_inc, 3)).astype(np.float32)

    o = np.concatenate([o_coh, o_inc]).astype(np.float32)
    d = np.concatenate([d_coh, d_inc]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def render_rays(s):
    """The rays the main path hands the kernels, from an engine state s:
    camera rays of every pixel, their first-bounce rays (a lane whose
    BSDF sample is impossible, as on the light, keeps its camera ray, as
    path_trace keeps a dead lane's ray), and 2N shadow lanes (towards a
    point on the first light, then along the bounce directions with tmax
    1 on every 8th lane and 0 elsewhere, as NEE leaves most of its second
    half dead). Returns ((o, d), (bo, bd), (so, sd, shadow_tmax)), rays
    as V3 (3, N) on the state's device."""
    from tracer_tpu_torch.models import camera as cam_mod
    from tracer_tpu_torch.models import scene as scene_mod
    from tracer_tpu_torch.ops import linalg as la
    from tracer_tpu_torch.ops import materials
    from tracer_tpu_torch.ops import rng as prng
    w, h = s.sub_dims
    n = w * h
    lane = torch.arange(n, device=s.device)
    st = prng.make_streams(s.seed, 1, lane)
    st, wl, _ = cam_mod.sample_wavelength(st, s.cam.conf)
    st, o, d = cam_mod.sample_ray(
        st, s.cam, (w, h), (lane % w).float(),
        float(h) - (lane // w).float() - 1.0)
    o = o.expand(3, n).contiguous()
    inter = scene_mod.closest_interaction(s.scene, shapes.F32_HIGHEST, o, d,
                                          wl)
    st, wi, _, pdf, kind = materials.sample_dir(st, -d, inter.normal,
                                                inter.mat)
    bo, bd = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
    bounce = inter.ok & ((kind == materials.PDF_DELTA)
                         | ((kind == materials.PDF_NONZERO) & (pdf != 0)))
    bo, bd = torch.where(bounce, bo, o), torch.where(bounce, bd, d)
    light = s.scene.light_table[0]
    st, (u, v) = prng.in_triangle(st)
    a, b, c = light[0:3, None], light[3:6, None], light[6:9, None]
    lp = a + u * (b - a) + v * (c - a)
    to_l = lp - inter.pos
    dist = la.v3_norm(to_l)
    so, sd = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, to_l)
    t_l = torch.where(inter.ok, dist - 0.01, 0.0)
    t_b = torch.where(inter.ok & (lane % 8 == 0), 1.0, 0.0)
    return ((o, d), (bo, bd),
            (torch.cat([so, bo], dim=1), torch.cat([sd, bd], dim=1),
             torch.cat([t_l, t_b])))


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
