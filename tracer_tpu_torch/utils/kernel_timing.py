"""Time the intersection kernels on their own, and count what K2 scans.

    python -m tracer_tpu_torch.utils.kernel_timing [--levels 6] [--size 512]

On a CUDA card only. Builds subdivide(cornell_like, levels) (cornell-sub6
at the default 6: 90,112 triangles in 352 chunks) at size x size, takes
the first-bounce rays and the 2N shadow lanes of
kernel_cases.render_rays in the odmorton order the main path gives them,
and prints the card's name and power limit, then one JSON line: per
streamed kernel (K2, K4) the median time of the launch alone (its
schedule built beforehand) and of the wrapper call (the schedule built
in each call), between CUDA events; K2's in-kernel counts as scanned
tests per lane beside the plain model's bracket (kernel_cases.cull_pairs)
and the tests the answer needs (kernel_cases.needed_tests); and K2
against K1 on the same rays. chip_smoke.py runs the same functions in
its bigscene phase.
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
    """init() of subdivide(cornell_like, levels) at size x size."""
    import tracer_tpu_torch as T
    from tracer_tpu_torch.utils.testscenes import cornell_like, subdivide
    tris, tm, mats = cornell_like()
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


def k2_scans(co, phi, tmax, cb) -> dict:
    """K2's in-kernel counts on one launch, as (lane, triangle) tests per
    lane: scanned = warp scans x 32 x chunk_t / N, beside the plain
    model's bracket at the final best t and at tmax, the same model at
    block granularity (the walk before warp culling, at 256-lane blocks),
    and the tests the answer needs. Also the chunks copied per block."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases as kc
    n = phi.shape[1]
    chunk_t = co.shape[1] // cb.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    stats = torch.zeros(2, dtype=torch.int64, device=phi.device)
    bt, _ = ik.closest_hit(co, phi, tmax, cb, stream=True, stats=stats)
    final = torch.minimum(bt, tmax)
    top = tmax.expand(n)
    per_lane = 32 * chunk_t / n
    out = {"lanes": n, "copies": int(stats[0]), "warp_scans": int(stats[1]),
           "scanned_per_lane": int(stats[1]) * per_lane}
    for key, tile, group in (("warp", ik.STREAMED_CLOSEST_BLOCK, 32),
                             ("block256", ik.BLOCK, ik.BLOCK)):
        g, _, order, count = ik.walk_schedule(phi, tmax, cb, ik.MAX_SCHED,
                                              tile)
        pairs = [int(kc.cull_pairs(phi, b, cb, g, order, count, tile,
                                   group).sum()) for b in (final, top)]
        out[f"{key}_model_per_lane"] = [p * group * chunk_t / n
                                        for p in pairs]
        if key == "warp":
            out["copies_per_block"] = int(stats[0]) / order.shape[0]
            out["entries_per_block"] = float(count.float().mean())
    near = torch.where(torch.isfinite(bt), bt, top)
    out["needed_per_lane"] = kc.needed_tests(phi, near, cb, chunk_t) / n
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=6)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a CUDA card")
    from tracer_tpu_torch.ops import cuda_lib, shapes
    from tracer_tpu_torch.ops import intersect_kernel as ik
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    ik.build()
    s = sub_state(args.levels, args.size, torch.device("cuda"))
    co, cb = s.scene.accel.coeffs, s.scene.accel.chunk_bounds
    phi_b, phi_s, st = timed_rays(s)
    hi = shapes.F32_HIGHEST
    print(json.dumps({
        "levels": args.levels, "size": args.size,
        "build_s": cuda_lib.build_info()["seconds"],
        "k2_block": ik.STREAMED_CLOSEST_BLOCK,
        "closest_hit_streamed": kernel_times("closest", co, phi_b, hi, cb,
                                             True),
        "any_hit_streamed": kernel_times("any", co, phi_s, st, cb, True),
        "k2_scans": k2_scans(co, phi_b, hi, cb),
        "k2_vs_k1": k2_vs_k1(co, phi_b, hi, cb)}), flush=True)


if __name__ == "__main__":
    main()
