"""Brute-force ray-triangle queries of the reference, in plain torch so
that the big scene's 90,112 triangles run on the card; every lane is
tested against every triangle, with no acceleration structure, no
chunks and no kernel of the program.

The test is the reference's Moller variant (shapes.fut:66-86 as
verify/ref_estimator_numpy.py reads it): a = -(d . n), s = o - a_v,
m = s x d, t = (s . n) / a, u = (m . e2) / a, v = -(m . e1) / a, valid
where |a| >= 1e-5, u, v >= 0, u + v <= 1 and 0 < t < tmax. A closest-hit
tie in t goes to the later triangle (bvh.fut:31-39). The dot products
are summed in a fixed order, x + y first.

precision="tf32" is the control: ray and triangle operands rounded to
TF32 (10 mantissa bits) before the test, as a tensor-core test would
read them; everything after it is float32.
"""

from __future__ import annotations

import numpy as np
import torch

TRI_EPS = 1e-5
PRECISIONS = ("float32", "tf32")
_BLOCK_ELEMS = 1 << 23   # lane x triangle pairs per block


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    return ((bits + 0xFFF + odd) & ~0x1FFF).view(torch.float32)


def _dot(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


class Triangles:
    """The scene's triangles on `device`: vertex a, edges e1 = b - a and
    e2 = c - a, and the unnormalised normal n = e1 x e2, as (T,) rows."""

    def __init__(self, tris: np.ndarray, device, precision="float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        t = np.asarray(tris, np.float32)
        a, e1, e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
        n = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=-1)
        self.device = torch.device(device)
        self.precision = precision
        self.count = t.shape[0]
        self.rows = [torch.as_tensor(np.ascontiguousarray(x.T),
                                     device=self.device)
                     for x in (a, e1, e2, n)]
        if precision == "tf32":
            self.rows = [tf32(r) for r in self.rows]

    def _rays(self, origin, direction, tmax):
        o = torch.as_tensor(np.ascontiguousarray(origin.T), device=self.device)
        d = torch.as_tensor(np.ascontiguousarray(direction.T),
                            device=self.device)
        if self.precision == "tf32":
            o, d = tf32(o), tf32(d)
        tm = torch.as_tensor(np.broadcast_to(np.asarray(tmax, np.float32),
                                             origin.shape[:1]).copy(),
                             device=self.device)
        return o, d, tm

    def _test(self, o, d, tm, i0, i1):
        """(valid, t) of lanes x triangles i0:i1."""
        a_v, e1, e2, n = (r[:, i0:i1] for r in self.rows)
        ox, oy, oz = (o[k][:, None] for k in range(3))
        dx, dy, dz = (d[k][:, None] for k in range(3))
        a = -_dot(dx, dy, dz, n[0], n[1], n[2])
        sx, sy, sz = ox - a_v[0], oy - a_v[1], oz - a_v[2]
        mx, my, mz = sy * dz - sz * dy, sz * dx - sx * dz, sx * dy - sy * dx
        inv_a = 1.0 / a
        t = _dot(sx, sy, sz, n[0], n[1], n[2]) * inv_a
        u = _dot(mx, my, mz, e2[0], e2[1], e2[2]) * inv_a
        v = -_dot(mx, my, mz, e1[0], e1[1], e1[2]) * inv_a
        valid = ((torch.abs(a) >= TRI_EPS) & (u >= 0) & (v >= 0)
                 & (u + v <= 1) & (t < tm[:, None]) & (t > 0))
        return valid, t

    def _blocks(self, n_lanes):
        step = max(1, _BLOCK_ELEMS // max(n_lanes, 1))
        lane_step = max(1, _BLOCK_ELEMS // min(step, self.count))
        for l0 in range(0, n_lanes, lane_step):
            for i0 in range(0, self.count, step):
                yield l0, min(n_lanes, l0 + lane_step), i0, \
                    min(self.count, i0 + step)

    def closest(self, origin, direction, tmax):
        """Closest hit of (L, 3) rays below tmax: (hit (L,), t (L,),
        index (L,) int64, 0 on a miss) as numpy."""
        o, d, tm = self._rays(origin, direction, tmax)
        n_lanes = o.shape[1]
        best_t = torch.full((n_lanes,), float("inf"), device=self.device)
        best_i = torch.zeros((n_lanes,), dtype=torch.int64,
                             device=self.device)
        for l0, l1, i0, i1 in self._blocks(n_lanes):
            valid, t = self._test(o[:, l0:l1], d[:, l0:l1], tm[l0:l1], i0, i1)
            tv = torch.where(valid, t, float("inf"))
            bt = tv.amin(dim=1)
            idx = torch.arange(i0, i1, device=self.device)
            bi = torch.where(tv == bt[:, None], idx, -1).amax(dim=1)
            # a later block wins a tie: its triangles come later
            take = torch.isfinite(bt) & (bt <= best_t[l0:l1])
            best_t[l0:l1] = torch.where(take, bt, best_t[l0:l1])
            best_i[l0:l1] = torch.where(take, bi, best_i[l0:l1])
        hit = torch.isfinite(best_t)
        return hit.cpu().numpy(), best_t.cpu().numpy(), best_i.cpu().numpy()

    def any(self, origin, direction, tmax):
        """True where some triangle is hit at 0 < t < tmax (L,)."""
        o, d, tm = self._rays(origin, direction, tmax)
        n_lanes = o.shape[1]
        out = torch.zeros((n_lanes,), dtype=torch.bool, device=self.device)
        for l0, l1, i0, i1 in self._blocks(n_lanes):
            valid, _ = self._test(o[:, l0:l1], d[:, l0:l1], tm[l0:l1], i0, i1)
            out[l0:l1] |= valid.any(dim=1)
        return out.cpu().numpy()
