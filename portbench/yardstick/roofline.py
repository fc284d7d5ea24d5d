"""The least time the card could take over the ray queries of a call,
from what the queries need, whatever implements them.

The work of a query is counted on the benchmark's own chunking of the
configuration's triangles: sorted by the Morton code of their centroids
and cut into chunks of CHUNK_T, each with its box. A lane needs the
tests of every chunk whose box its ray enters (the exact slab test) at
a t in [0, bound]: for a closest hit the bound is the hit's t, or tmax
where it hits nothing; for an any hit it is tmax, and an occluded lane
needs one chunk. A lane with tmax <= 0 needs no test. (A frozen copy of
the port's utils/kernel_cases.needed_tests on this chunking.)

One test is the Moller test on a triangle's vertex, edges and normal:
a = -(d . n), s = o - v0, m = s x d, the dot products s . n, m . e2 and
m . e1, one divide and three multiplies for t, u and v, one add for
u + v: FLOPS_PER_TEST f32 operations (comparisons not counted). Bytes:
each triangle (9 floats) and each live lane's ray (6 floats) read once,
every lane's tmax read once and its answer written once.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

CHUNK_T = 256
FLOPS_PER_TEST = 37
TRI_BYTES = 36
RAY_BYTES = 24
TMAX_BYTES = 4
ANSWER_BYTES = {"closest": 8, "any": 1}
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(card: str) -> dict | None:
    """The card's published rates, None for a card not in the table."""
    with open(PEAKS) as f:
        return json.load(f)["cards"].get(card)


def _spread10(v):
    v = v.astype(np.uint64) & np.uint64(0x3FF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
    return v


def chunks(tris, chunk_t: int = CHUNK_T):
    """(boxes (C, 6) [min xyz, max xyz], sizes (C,)) of the triangles
    (T, 3, 3) in chunks of chunk_t, Morton-sorted by centroid."""
    tris = np.asarray(tris, np.float32)
    c = tris.mean(axis=1)
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-30) * 1023.0, 0, 1023)
    code = (_spread10(q[:, 0]) << np.uint64(2)) | (_spread10(q[:, 1])
                                                   << np.uint64(1)) \
        | _spread10(q[:, 2])
    order = np.argsort(code, kind="stable")
    boxes, sizes = [], []
    for i in range(0, len(order), chunk_t):
        t = tris[order[i:i + chunk_t]].reshape(-1, 3)
        boxes.append(np.concatenate([t.min(axis=0), t.max(axis=0)]))
        sizes.append(len(order[i:i + chunk_t]))
    return np.stack(boxes).astype(np.float32), np.asarray(sizes, np.int64)


def entered(o, d, bound, boxes, closed: bool):
    """(C, N): where each lane's ray (o, d (3, N)) enters each box at a t
    in [0, bound] (closed) or [0, bound) (open), by the exact slab test;
    a ray parallel to an axis passes it only from inside that slab."""
    shape = (boxes.shape[0], o.shape[1])
    tmin = torch.zeros(shape, device=o.device)
    tmx = bound[None].expand(shape)
    inside = torch.ones(shape, dtype=torch.bool, device=o.device)
    for k in range(3):
        lo, hi = boxes[:, k, None], boxes[:, 3 + k, None]
        par = (d[k] == 0.0)[None]
        inv = 1.0 / torch.where(par, 1.0, d[k][None])
        t0, t1 = (lo - o[k]) * inv, (hi - o[k]) * inv
        tmin = torch.maximum(tmin, torch.where(par, 0.0,
                                               torch.minimum(t0, t1)))
        tmx = torch.minimum(tmx, torch.where(par, float("inf"),
                                             torch.maximum(t0, t1)))
        inside &= ~par | ((lo <= o[k]) & (o[k] <= hi))
    reach = tmin <= tmx if closed else (tmin <= tmx) & (tmin < bound[None])
    return reach & inside


def needed_tests(tap: dict, boxes, sizes, batch: int = 1 << 24) -> int:
    """Tests the tapped lanes of one query need (see the module's
    docstring), not yet scaled by the tap's stride."""
    o, d, tmax = tap["o"], tap["d"], tap["tmax"]
    live = tmax > 0
    if tap["query"] == "closest":
        t = tap["t"]
        bound = torch.where(torch.isfinite(t), torch.minimum(t, tmax), tmax)
        free, closed, total = live, True, 0
    else:
        occ = tap["hit"] & live
        bound, free, closed = tmax, live & ~occ, False
        total = int(occ.sum()) * int(sizes.min())
    step = max(1, batch // max(o.shape[1], 1))
    for i in range(0, boxes.shape[0], step):
        hit = entered(o, d, bound, boxes[i:i + step], closed) & free[None]
        total += int((hit.sum(dim=1) * sizes[i:i + step]).sum())
    return total


def bound_s(taps: list, tris, stride: int, card_peaks: dict) -> dict:
    """{"closest": s, "any": s}: the least seconds the card could spend
    on the tapped call's queries of each kind, the larger of bytes over
    the memory rate and operations over the f32 rate, per query."""
    boxes_np, sizes_np = chunks(tris)
    out = {"closest": 0.0, "any": 0.0}
    if not taps:
        return out
    dev = taps[0]["o"].device
    boxes = torch.as_tensor(boxes_np, device=dev)
    sizes = torch.as_tensor(sizes_np, device=dev)
    n_tris = int(np.asarray(tris).shape[0])
    for tap in taps:
        tests = needed_tests(tap, boxes, sizes) * stride
        moved = (TRI_BYTES * n_tris + RAY_BYTES * tap["live"]
                 + (TMAX_BYTES + ANSWER_BYTES[tap["query"]]) * tap["n"])
        out[tap["query"]] += max(moved / card_peaks["hbm_bytes_per_s"],
                                 tests * FLOPS_PER_TEST
                                 / card_peaks["f32_flops_per_s"])
    return out
