"""Time the intersection kernels on their own, and count what K2 and K4
scan.

    python -m tracer_tpu_torch.utils.kernel_timing [--levels 6] [--size 512]

On a CUDA card only. Builds subdivide(cornell_like, levels) (cornell-sub6
at the default 6: 90,112 triangles in 352 chunks) at size x size, takes
the first-bounce rays and the 2N shadow lanes of
kernel_cases.render_rays in the odmorton order the main path gives them,
and prints the card's name and power limit, then one JSON line: the
kernels' lanes per block; per streamed kernel (K2, K4), and for K3 on the
same lanes and on the shadow lanes of the one-chunk Cornell box (where
its main path launches it), the median time of the launch alone (its
schedule built beforehand) and of the wrapper call (the schedule built
in each call), between CUDA events; K2's and K4's in-kernel counts as
scanned tests per lane beside the plain model's bracket
(kernel_cases.cull_pairs) and the tests the answer needs
(kernel_cases.needed_tests); K2 against K1 on the same rays, K2 with its
tiles longest schedule first, and K3 and K4 against K1's hits on the same
lanes. chip_smoke.py runs the same
functions. A design step is this command on a copy of the tree that
differs in one constant.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

CAM_ORIGIN = (0.0, 0.8, 1.8)
REL = 1e-5


def ms_per_call(fn, calls: int = 20, rounds: int = 5) -> float:
    """Median over `rounds` of the CUDA-event time of `calls` back-to-back
    calls divided by `calls`, after two warm-up calls. Back to back, the
    host work of a call overlaps the previous call's device work."""
    fn()
    fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def graph_ms_per_call(fn, calls: int = 20, rounds: int = 5) -> float:
    """Device time per call with no host work between calls: `calls`
    calls captured in one CUDA graph, the median over `rounds` replays of
    the CUDA-event time of one replay divided by `calls`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def host_us_per_call(fn, calls: int = 2000) -> float:
    """Host microseconds per call: the host clock over `calls` calls
    queued back to back, taken before the one synchronise that follows,
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / calls


def card_line() -> str:
    """The card as nvidia-smi names it: name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sub_state(levels: int, size: int, device):
    """init() of subdivide(cornell_like, levels) at size x size (levels 0:
    the one-chunk Cornell box itself)."""
    import tracer_tpu_torch as T
    from tracer_tpu_torch.utils.testscenes import cornell_like, subdivide
    tris, tm, mats = cornell_like()
    if levels:
        tris, tm = subdivide(tris, tm, levels=levels)
    return T.init(0, size, size, 0, tris, tm, mats, cam_origin=CAM_ORIGIN,
                  device=device)


def timed_rays(s):
    """The timed queries of a state: (first-bounce phi, shadow phi, shadow
    tmax), each in the odmorton order (dead shadow lanes first), as the
    main path hands them to the kernels."""
    from tracer_tpu_torch.ops import intersect, shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    cb = s.scene.accel.chunk_bounds
    _, (bo, bd), (so, sd, st) = kc.render_rays(s)
    phi_b = intersect.ray_features_t(bo, bd)
    phi_s = intersect.ray_features_t(so, sd)
    idx_b = intersect.lane_order(phi_b, shapes.F32_HIGHEST, cb, "odmorton")
    idx_s = intersect.lane_order(phi_s, st, cb, "odmorton", dead_first=True)
    return (phi_b[:, idx_b].contiguous(), phi_s[:, idx_s].contiguous(),
            st[idx_s].contiguous())


def kernel_times(query: str, co, phi, tmax, cb, stream: bool) -> dict:
    """ms: the wrapper call (schedule built each call); alone_ms: the
    kernel's launch with the schedule built once beforehand."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    call = ik.closest_hit if query == "closest" else ik.any_hit
    launch, _ = ik.prepared_launch(query, co, phi, tmax, cb, stream=stream)
    return {"ms": ms_per_call(lambda: call(co, phi, tmax, cb, stream=stream)),
            "alone_ms": ms_per_call(launch)}


def _model_per_lane(phi, tmax, bounds, cb, chunk_t: int, tile: int,
                    group: int) -> tuple:
    """The plain model of the cull (kernel_cases.cull_pairs) as (lane,
    triangle) tests per lane at each of the per-lane `bounds`: groups of
    `group` lanes in tiles of `tile` lanes, whose schedule is built at
    tmax as the wrapper builds it. Returns (tests per lane for each
    bound, chunks some group of a tile reaches at the last bound per tile
    (n_tiles,), count)."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases as kc
    g, _, order, count = ik.walk_schedule(phi, tmax, cb, ik.MAX_SCHED, tile)
    per_pair = group * chunk_t / phi.shape[1]
    pairs = [kc.cull_pairs(phi, b, cb, g, order, count, tile, group)
             for b in bounds]
    copies = pairs[-1].reshape(-1, tile // group, cb.shape[0]).any(dim=1)
    return ([int(p.sum()) * per_pair for p in pairs], copies.sum(dim=1),
            count)


def _scans(name: str, stats, phi, tmax, bounds, cb, chunk_t: int) -> dict:
    """A streamed kernel's in-kernel counts of one launch as (lane,
    triangle) tests per lane, scanned = warp scans x 32 x chunk_t / N,
    beside the plain model's bracket at `bounds` = (least, most), and the
    same model at block granularity (the walk before warp culling, at
    256-lane blocks). Also the chunks copied per block, and the mean and
    the largest number of chunks the model has one block copy at the
    upper bound: how unevenly the walks are spread over the blocks."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    n = phi.shape[1]
    out = {"lanes": n, "copies": int(stats[0]), "warp_scans": int(stats[1]),
           "scanned_per_lane": int(stats[1]) * 32 * chunk_t / n}
    out["warp_model_per_lane"], copies, count = _model_per_lane(
        phi, tmax, bounds, cb, chunk_t, ik.BLOCKS[name], 32)
    out["block256_model_per_lane"], _, _ = _model_per_lane(
        phi, tmax, bounds, cb, chunk_t, 256, 256)
    out["copies_per_block"] = int(stats[0]) / count.shape[0]
    out["model_copies_per_block"] = [float(copies.float().mean()),
                                     int(copies.max())]
    out["entries_per_block"] = [float(count.float().mean()), int(count.max())]
    return out


def k2_scans(co, phi, tmax, cb) -> dict:
    """K2's counts (_scans) on one launch: the bracket is the model at the
    final best t and at tmax; needed: the tests the answer needs."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases as kc
    chunk_t = co.shape[1] // cb.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    stats = torch.zeros(2, dtype=torch.int64, device=phi.device)
    bt, _ = ik.closest_hit(co, phi, tmax, cb, stream=True, stats=stats)
    top = tmax.expand(phi.shape[1])
    out = _scans("closest_hit_streamed", stats, phi, tmax,
                 (torch.minimum(bt, tmax), top), cb, chunk_t)
    near = torch.where(torch.isfinite(bt), bt, top)
    out["needed_per_lane"] = (kc.needed_tests(phi, near, cb, chunk_t)
                              / phi.shape[1])
    return out


def k4_scans(co, phi, tmax, cb) -> dict:
    """K4's counts (_scans) on one launch. A lane that is never occluded
    stays in the walk to its end, so its warp scans every scheduled chunk
    the lane may hit at its tmax: the least is the model with the occluded
    and the dead lanes given a NaN bound, which passes nothing; the most
    is the model with every lane at its tmax, as if none stopped."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases as kc
    n = phi.shape[1]
    chunk_t = co.shape[1] // cb.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=phi.device).expand(n)
    stats = torch.zeros(2, dtype=torch.int64, device=phi.device)
    hit = ik.any_hit(co, phi, tmax, cb, stream=True, stats=stats)
    out = _scans("any_hit_streamed", stats, phi, tmax,
                 (kc.unstopped_bound(tmax, hit), tmax), cb, chunk_t)
    out["occluded"] = int(hit.sum())
    out["dead"] = int((~(tmax > 0)).sum())
    out["needed_per_lane"] = kc.needed_tests(phi, tmax, cb, chunk_t,
                                             occluded=hit) / n
    return out


def k2_vs_k1(co, phi, tmax, cb) -> dict:
    """K2 against K1 (resident, block-granular) on the same lanes: lanes
    whose best_t differs in any bit, and lanes whose best_i differs
    outside the REL tie band (float64, kernel_cases.boundary_lanes on
    those lanes)."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases as kc
    t2, i2 = ik.closest_hit(co, phi, tmax, cb, stream=True)
    t1, i1 = ik.closest_hit(co, phi, tmax, cb, stream=False)
    bits = t2.view(torch.int32) != t1.view(torch.int32)
    lanes = torch.nonzero(i2 != i1)[:, 0]
    idx = 0
    if lanes.numel():
        tm = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
        tm = tm[lanes] if tm.dim() else tm
        edge, tie = kc.boundary_lanes(co, phi[:, lanes].contiguous(), tm,
                                      cb, rel=REL)
        idx = int((~tie & ~edge).sum())
    return {"lanes": phi.shape[1], "best_t_bits_differ": int(bits.sum()),
            "best_i_differ": int(lanes.numel()),
            "best_i_differ_outside_ties": idx}


def k2_block_order(co, phi, tmax, cb) -> dict:
    """K2 alone with its blocks in index order, as it launches them, and
    with whole tiles of lanes moved so that the tiles with the longest
    schedules come first (ik.heavy_first, the order K3 and K4 work their
    tiles in): what that order would be worth on K2."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    tile = ik.STREAMED_CLOSEST_BLOCK
    n = phi.shape[1] // tile * tile
    phi = phi[:, :n]
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=phi.device).expand(n)
    _, _, _, count = ik.walk_schedule(phi, tmax, cb, ik.MAX_SCHED, tile)
    out = {}
    for key, tiles in (("index_order_ms", None),
                       ("heavy_first_ms", ik.heavy_first(count).long())):
        p, t = phi.contiguous(), tmax.contiguous()
        if tiles is not None:
            lanes = (tiles[:, None] * tile
                     + torch.arange(tile, device=phi.device)).reshape(-1)
            p, t = phi[:, lanes].contiguous(), tmax[lanes].contiguous()
        launch, _ = ik.prepared_launch("closest", co, p, t, cb, stream=True)
        out[key] = ms_per_call(launch)
    return out


def any_vs_k1(co, phi, tmax, cb, stream: bool) -> dict:
    """K3 (stream False) or K4 (True) against K1's hits, isfinite(best_t)
    at the same per-lane tmax, on every lane and with no boundary band:
    K1 takes the exact divide on every triangle, and the any-hit kernels
    report a hit only from that same path."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    hit = ik.any_hit(co, phi, tmax, cb, stream=stream)
    bt, _ = ik.closest_hit(co, phi, tmax, cb, stream=False)
    return {"lanes": phi.shape[1], "hits": int(hit.sum()),
            "differ": int((hit != torch.isfinite(bt)).sum())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=6)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a CUDA card")
    from tracer_tpu_torch.ops import cuda_lib, intersect, shapes
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    ik.build()
    s = sub_state(args.levels, args.size, torch.device("cuda"))
    co, cb = s.scene.accel.coeffs, s.scene.accel.chunk_bounds
    phi_b, phi_s, st = timed_rays(s)
    hi = shapes.F32_HIGHEST
    box = sub_state(0, args.size, torch.device("cuda"))
    box_co, box_cb = box.scene.accel.coeffs, box.scene.accel.chunk_bounds
    # the box's any-hit queries are not sorted (one chunk: perm="auto" off)
    _, _, (so, sd, box_st) = kernel_cases.render_rays(box)
    box_phi = intersect.ray_features_t(so, sd)
    print(json.dumps({
        "levels": args.levels, "size": args.size,
        "build_s": cuda_lib.build_info()["seconds"],
        "k2_block": ik.STREAMED_CLOSEST_BLOCK, "k3_block": ik.ANY_BLOCK,
        "k4_block": ik.STREAMED_ANY_BLOCK,
        "closest_hit_streamed": kernel_times("closest", co, phi_b, hi, cb,
                                             True),
        "any_hit_streamed": kernel_times("any", co, phi_s, st, cb, True),
        "any_hit": kernel_times("any", co, phi_s, st, cb, False),
        "any_hit_cornell": kernel_times("any", box_co, box_phi, box_st,
                                        box_cb, False),
        "k2_scans": k2_scans(co, phi_b, hi, cb),
        "k4_scans": k4_scans(co, phi_s, st, cb),
        "k2_vs_k1": k2_vs_k1(co, phi_b, hi, cb),
        "k2_block_order": k2_block_order(co, phi_b, hi, cb),
        "k4_vs_k1": any_vs_k1(co, phi_s, st, cb, True),
        "k3_vs_k1": any_vs_k1(co, phi_s, st, cb, False),
        "k3_vs_k1_cornell": any_vs_k1(box_co, box_phi, box_st, box_cb,
                                      False)}), flush=True)


if __name__ == "__main__":
    main()
