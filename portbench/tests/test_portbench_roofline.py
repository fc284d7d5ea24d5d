"""The benchmark's count of the tests a query needs, against a count
made lane by lane and chunk by chunk in float64 on a tiny scene."""

import numpy as np
import pytest
import torch

from portbench.reference import scene as scene_mod
from portbench.yardstick import roofline


def slab_enters(o, d, bound, box, closed):
    tmin, tmax = 0.0, bound
    for k in range(3):
        lo, hi = box[k], box[3 + k]
        if d[k] == 0.0:
            if not lo <= o[k] <= hi:
                return False
            continue
        t0, t1 = (lo - o[k]) / d[k], (hi - o[k]) / d[k]
        tmin, tmax = max(tmin, min(t0, t1)), min(tmax, max(t0, t1))
    return tmin <= tmax if closed else (tmin <= tmax and tmin < bound)


def brute_force(tap, boxes, sizes):
    o, d = tap["o"].double().numpy().T, tap["d"].double().numpy().T
    tmax = tap["tmax"].double().numpy()
    total = 0
    for i in range(len(tmax)):
        if not tmax[i] > 0:
            continue
        if tap["query"] == "closest":
            t = float(tap["t"][i])
            bound = min(t, tmax[i]) if np.isfinite(t) else tmax[i]
            closed = True
        else:
            if bool(tap["hit"][i]):
                total += int(sizes.min())
                continue
            bound, closed = tmax[i], False
        total += sum(int(s) for b, s in zip(boxes, sizes)
                     if slab_enters(o[i], d[i], bound, b, closed))
    return total


@pytest.mark.parametrize("levels,chunk_t", [(0, 256), (2, 64), (2, 16)])
def test_needed_tests_equal_a_brute_force_count(levels, chunk_t):
    tris, tm, _ = scene_mod.generate("cornell_like")
    tris, tm = scene_mod.subdivide(tris, tm, levels)
    boxes, sizes = roofline.chunks(tris, chunk_t)
    assert sizes.sum() == len(tris)
    r = np.random.default_rng(levels + chunk_t)
    n = 96
    o = torch.as_tensor(r.uniform([-1, 0, -1], [1, 2, 1], (n, 3)).T,
                        dtype=torch.float32)
    d = torch.as_tensor(r.normal(size=(n, 3)).T, dtype=torch.float32)
    d[:, :8] = torch.tensor([0.0, 0.0, -1.0])[:, None]   # axis-parallel
    d = d / torch.linalg.vector_norm(d, dim=0)
    tmax = torch.as_tensor(r.uniform(0.1, 3.0, n), dtype=torch.float32)
    tmax[::7] = 0.0                                      # dead lanes
    t = torch.as_tensor(r.uniform(0.05, 2.0, n), dtype=torch.float32)
    t[::5] = float("inf")                                # misses
    hit = torch.as_tensor(r.random(n) < 0.3)
    tb, sb = torch.as_tensor(boxes), torch.as_tensor(sizes)
    for tap in ({"query": "closest", "o": o, "d": d, "tmax": tmax, "t": t},
                {"query": "any", "o": o, "d": d, "tmax": tmax, "hit": hit}):
        assert roofline.needed_tests(tap, tb, sb) == brute_force(
            tap, boxes, sizes)


def test_bound_is_the_larger_of_bytes_and_operations():
    tris, _, _ = scene_mod.generate("cornell_like")
    peaks = {"f32_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    o = torch.tensor([[0.0], [1.0], [0.9]]).repeat(1, 4)
    d = torch.tensor([[0.0], [0.0], [-1.0]]).repeat(1, 4)
    tap = {"query": "closest", "n": 64, "live": 64, "o": o, "d": d,
           "tmax": torch.full((4,), 10.0), "t": torch.full((4,), 1.9)}
    out = roofline.bound_s([tap], tris, 16, peaks)
    moved = 36 * 22 + 24 * 64 + (4 + 8) * 64
    tests = 4 * 16 * 22
    assert out["closest"] == pytest.approx(max(moved / 1e9,
                                               tests * 37 / 1e12))
    assert out["any"] == 0.0
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["f32_flops_per_s"] == 67e12
    assert roofline.peaks("some other card") is None
