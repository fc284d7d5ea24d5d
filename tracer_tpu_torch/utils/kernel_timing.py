"""Time the intersection kernels on their own, count what K2 and K4 scan,
and hold K1-K4 to the exact yardstick kernel.

    python -m tracer_tpu_torch.utils.kernel_timing [--levels 6] [--size 512]
    python -m tracer_tpu_torch.utils.kernel_timing --k1
    python -m tracer_tpu_torch.utils.kernel_timing --k1-block-sizes

On a CUDA card only; each prints the card's name and power limit, then
one JSON line.

The first builds subdivide(cornell_like, levels) (cornell-sub6 at the
default 6: 90,112 triangles in 352 chunks) at size x size, takes the
first-bounce rays and the 2N shadow lanes of kernel_cases.render_rays in
the odmorton order the main path gives them, and prints: the kernels'
lanes per block; per streamed kernel (K2, K4), and for K3 on the same
lanes and on the shadow lanes of the one-chunk Cornell box (where its
main path launches it), the median time of the launch alone (its
schedule built beforehand) and of the wrapper call (the schedule built
in each call), between CUDA events; K2's and K4's in-kernel counts as
scanned tests per lane beside the plain model's bracket
(kernel_cases.cull_pairs) and the tests the answer needs
(kernel_cases.needed_tests); K2 against the exact kernel on the same
rays, K2 with its tiles in index order and longest schedule first, K3
and K4 against the exact kernel's hits on the same lanes; K1 and K2 on
the same first-bounce rays of subdivide(cornell_like, 4), 5 and 6
(stream_pairs: where streaming pays); and K1's numbers (k1_report).

--k1 prints k1_report alone: K1's lanes per block, blocks per SM,
registers and spills (ptxas -v), its time at the Cornell shapes, the
capture's and cornell-sub6 resident, beside the exact kernel's at the
Cornell shapes, and K1 against the exact kernel on each ray set.
--k1-block-sizes runs that in copies of the package under build/ that
differ in K1's lanes per block and blocks per SM (K1_SWEEP), the
unchanged constants first and last. chip_smoke.py runs the same
functions. Any other design step is this command on a copy of the tree
that differs in one constant.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

CAM_ORIGIN = (0.0, 0.8, 1.8)
REL = 1e-5


@contextlib.contextmanager
def tap(module, name, calls):
    """Within the block, each call of module.name also appends (args,
    kwargs, result) to calls."""
    fn = getattr(module, name)

    def tapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, tapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


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


def sub_state(levels: int, size: int, device, conf: int = 0,
              height: int | None = None):
    """init() of subdivide(cornell_like, levels) at size x (height or
    size), sensor config conf (levels 0: the one-chunk Cornell box
    itself)."""
    import tracer_tpu_torch as T
    from tracer_tpu_torch.utils.testscenes import cornell_like, subdivide
    tris, tm, mats = cornell_like()
    if levels:
        tris, tm = subdivide(tris, tm, levels=levels)
    return T.init(0, height or size, size, conf, tris, tm, mats,
                  cam_origin=CAM_ORIGIN, device=device)


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
    kernel's launch with the schedule built once beforehand. query:
    "closest", "any" or "exact" (stream False)."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    if query == "exact":   # the yardstick kernel, resident only
        def call(*args, stream):
            return ik.closest_hit_exact(*args)
    else:
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


def closest_vs_exact(co, phi, tmax, cb, stream: bool, **kw) -> dict:
    """K1 (stream False) or K2 (True) against the exact kernel on the
    same lanes: lanes whose best_t differs in any bit, and lanes whose
    best_i differs at all and outside the REL tie band (float64,
    kernel_cases.boundary_lanes on those lanes). best_i can differ only
    where the two walks visit chunks in another order, i.e. where the
    lanes per block differ. kw: max_sched, for both."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases as kc
    t2, i2 = ik.closest_hit(co, phi, tmax, cb, stream=stream, **kw)
    t1, i1 = ik.closest_hit_exact(co, phi, tmax, cb, **kw)
    bits = t2.view(torch.int32) != t1.view(torch.int32)
    lanes = torch.nonzero(i2 != i1)[:, 0]
    idx = 0
    if lanes.numel():
        tm = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
        tm = tm[lanes] if tm.dim() else tm
        edge, tie = kc.boundary_lanes(co, phi[:, lanes].contiguous(), tm,
                                      cb, rel=REL)
        idx = int((~tie & ~edge).sum())
    return {"lanes": phi.shape[1], "hits": int(torch.isfinite(t1).sum()),
            "best_t_bits_differ": int(bits.sum()),
            "best_i_differ": int(lanes.numel()),
            "best_i_differ_outside_ties": idx}


def k2_block_order(co, phi, tmax, cb) -> dict:
    """K2 alone with its tiles longest schedule first, as it launches
    them (ik.heavy_first), and in index order: the same launch with
    heavy_first returning the identity while it is prepared."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    out = {}
    for key, order in (
            ("heavy_first_ms", ik.heavy_first),
            ("index_order_ms", lambda count: torch.arange(
                count.shape[0], dtype=torch.int32, device=count.device))):
        kept = ik.heavy_first
        ik.heavy_first = order
        try:
            launch, _ = ik.prepared_launch("closest", co, phi, tmax, cb,
                                           stream=True)
        finally:
            ik.heavy_first = kept
        out[key] = ms_per_call(launch)
    return out


def any_vs_exact(co, phi, tmax, cb, stream: bool) -> dict:
    """K3 (stream False) or K4 (True) against the exact kernel's hits,
    isfinite(best_t) at the same per-lane tmax, on every lane and with no
    boundary band: the exact kernel takes the IEEE divide on every
    triangle, and the any-hit kernels report a hit only from that same
    arithmetic."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    hit = ik.any_hit(co, phi, tmax, cb, stream=stream)
    bt, _ = ik.closest_hit_exact(co, phi, tmax, cb)
    return {"lanes": phi.shape[1], "hits": int(hit.sum()),
            "differ": int((hit != torch.isfinite(bt)).sum())}


def stream_pairs(size: int, device, levels=(4, 5, 6), states=None) -> dict:
    """Where streaming pays on this card: K1 (resident) and K2 (streamed)
    alone on the same first-bounce rays of subdivide(cornell_like, l), in
    the odmorton order, and K3 and K4 on its 2N shadow lanes, for each l:
    {l: {"t_pad", "lanes", "k1_alone_ms", "k2_alone_ms", "k3_alone_ms",
    "k4_alone_ms"}}. Each pair gives the same results, so
    ik.STREAM_MIN_T_PAD decides only the time. states: {l: a state
    already built at that level and size}."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.ops import shapes
    out = {}
    for lv in levels:
        s = (states or {}).get(lv) or sub_state(lv, size, device)
        co, cb = s.scene.accel.coeffs, s.scene.accel.chunk_bounds
        phi, phi_s, st = timed_rays(s)
        row = {"t_pad": co.shape[1], "lanes": phi.shape[1]}
        for key, query, p, tm, stream in (
                ("k1_alone_ms", "closest", phi, shapes.F32_HIGHEST, False),
                ("k2_alone_ms", "closest", phi, shapes.F32_HIGHEST, True),
                ("k3_alone_ms", "any", phi_s, st, False),
                ("k4_alone_ms", "any", phi_s, st, True)):
            launch, _ = ik.prepared_launch(query, co, p, tm, cb,
                                           stream=stream)
            row[key] = ms_per_call(launch, calls=10, rounds=5)
        out[lv] = row
    return out


def bounce_queries(integrator, s, with_points: bool = False) -> list:
    """Every closest-hit query of one 1-spp frame of state s, as the path
    hands it to the kernel wrapper: [(coeffs, phi, tmax, chunk_bounds,
    kwargs)], one per bounce iteration."""
    from tracer_tpu_torch.ops import intersect_kernel as ik
    w, h = s.sub_dims
    calls = []
    with tap(ik, "closest_hit", calls):
        integrator.render_frames(s.seed, s.nonce + 1, s.scene, s.cam,
                                 s.ambience, w, h, s.transmitter_kind, 1,
                                 s.render_mode, with_points=with_points)
    return [(*args, kw) for args, kw, _ in calls]


def bounce_times(queries, partition: bool = False, calls: int = 20,
                 rounds: int = 5) -> list:
    """Per bounce iteration of bounce_queries: the live share of the
    lanes (tmax > 0), the closest-hit kernel's launch alone on them
    (kernel_ms) and, with `partition` (a one-chunk scene, whose lanes the
    path does not sort), the wrapper call on the lanes as they are
    (unsorted_ms) and with the dead lanes partitioned first, as a sorted
    query would hand them over (partition_ms covers the stable sort on
    tmax > 0, the gather, the kernel and the two scatters): what the path
    would pay to free whole warps where it does not sort anyway."""
    from tracer_tpu_torch.ops import intersect_kernel as ik

    def partitioned(co, phi, tm, cb):
        idx = torch.sort(tm > 0, stable=True).indices
        bt_s, bi_s = ik.closest_hit(co, phi[:, idx], tm[idx], cb)
        bt, bi = torch.empty_like(bt_s), torch.empty_like(bi_s)
        bt[idx] = bt_s
        bi[idx] = bi_s
        return bt, bi

    out = []
    for co, phi, tm, cb, kw in queries:
        tm = torch.as_tensor(tm, dtype=torch.float32,
                             device=phi.device).expand(phi.shape[1])
        launch, _ = ik.prepared_launch("closest", co, phi, tm, cb, **kw)
        row = {"live_share": float((tm > 0).float().mean()),
               "kernel_ms": ms_per_call(launch, calls, rounds)}
        if partition:
            for key, fn in (("unsorted_ms", ik.closest_hit),
                            ("partition_ms", partitioned)):
                row[key] = ms_per_call(lambda: fn(co, phi, tm, cb), calls,
                                       rounds)
        out.append(row)
    return out


def spread_sweep(integrator, s, targets=(0, 2048, 4096, 8192),
                 calls: int = 5, rounds: int = 3) -> dict:
    """What dealing the live lanes out over more warps is worth
    (intersect.SPREAD_WARPS, lane_order): every sorted closest- and
    any-hit query of one 1-spp frame of state s, as the path hands it to
    intersect.closest_hit_phi / any_hit_phi, timed as a whole (sort,
    gather, schedule, kernel, scatter) at each target. Returns
    {"closest" | "any": {"live_share": [per bounce], target: [ms per
    bounce]}}; the results at every target equal those at 0 in best_t
    bits and hits, or it raises."""
    from tracer_tpu_torch.ops import intersect
    w, h = s.sub_dims
    taps = {"closest": [], "any": []}
    with tap(intersect, "closest_hit_phi", taps["closest"]), \
            tap(intersect, "any_hit_phi", taps["any"]):
        integrator.render_frames(s.seed, s.nonce + 1, s.scene, s.cam,
                                 s.ambience, w, h, s.transmitter_kind, 1,
                                 s.render_mode)
    kept = intersect.SPREAD_WARPS
    out = {}
    try:
        for query, fn in (("closest", intersect.closest_hit_phi),
                          ("any", intersect.any_hit_phi)):
            rows = {"live_share": [
                float((torch.as_tensor(a[1]) > 0).float().mean())
                for a, _, _ in taps[query]]}
            for target in targets:
                intersect.SPREAD_WARPS = target
                rows[target] = []
                for args, kw, ref in taps[query]:
                    got = fn(*args, **kw)
                    same = (torch.equal(got, ref) if query == "any" else
                            torch.equal(got[0].view(torch.int32),
                                        ref[0].view(torch.int32)))
                    if not same:
                        raise AssertionError(
                            f"{query} query differs at SPREAD_WARPS={target}")
                    rows[target].append(
                        ms_per_call(lambda: fn(*args, **kw), calls, rounds))
            out[query] = rows
    finally:
        intersect.SPREAD_WARPS = kept
    return out


def _entry_resources(kernel: str) -> dict:
    """ptxas -v of the entry function whose name holds `kernel` followed
    by its argument list (cuda_lib.kernel_resources)."""
    from tracer_tpu_torch.ops import cuda_lib
    for name, res in cuda_lib.kernel_resources().items():
        if re.search(rf"\d{kernel}E", name):
            return res
    return {}


def k1_report(size: int, device, sub6=None) -> dict:
    """K1 as built: lanes per block, blocks per SM at least, registers and
    spills; wrapper and launch-alone ms at the Cornell shapes (size^2
    first-bounce rays on the one-chunk box), at the capture's (640x480
    first-bounce rays of sensor config 2) and on cornell-sub6's
    first-bounce rays with stream=False; the exact kernel at the Cornell
    shapes in the same run; K1 against the exact kernel on each set."""
    from tracer_tpu_torch.ops import intersect, shapes
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases as kc
    lib = ik.build()
    hi = shapes.F32_HIGHEST
    out = {"block": ik.BLOCK, "min_blocks": lib.closest_min_blocks(),
           **_entry_resources("closest_hit_kernel")}
    sets = {}
    for key, s in (("cornell", sub_state(0, size, device)),
                   ("capture", sub_state(0, 640, device, conf=2,
                                         height=480))):
        _, (bo, bd), _ = kc.render_rays(s)
        sets[key] = (s.scene.accel, intersect.ray_features_t(bo, bd))
    sub6 = sub6 or sub_state(6, size, device)
    sets["sub6_resident"] = (sub6.scene.accel, timed_rays(sub6)[0])
    for key, (dense, phi) in sets.items():
        co, cb = dense.coeffs, dense.chunk_bounds
        out[key] = {"lanes": phi.shape[1],
                    **kernel_times("closest", co, phi, hi, cb, False),
                    "vs_exact": closest_vs_exact(co, phi, hi, cb, False)}
    dense, phi = sets["cornell"]
    out["exact_cornell"] = kernel_times("exact", dense.coeffs, phi, hi,
                                        dense.chunk_bounds, False)
    return out


# K1's (lanes per block, blocks per SM at least) of --k1-block-sizes; the
# kept pair first and last, so that the sweep shows its own drift
K1_SWEEP = ((256, 4), (64, 16), (128, 8), (128, 6), (256, 3), (256, 5),
            (512, 2), (256, 4))


def k1_block_sizes(configs=K1_SWEEP, root: Path | None = None) -> list:
    """k1_report for each (lanes per block, blocks per SM) of `configs`:
    the package is copied under build/k1_sweep/, kBlock and
    kClosestMinBlocks of csrc/intersect.cu and BLOCK of
    ops/intersect_kernel.py are rewritten in the copy, and the copy runs
    `python -m tracer_tpu_torch.utils.kernel_timing --k1` in a process of
    its own (its own nvcc build). Returns the reports in order."""
    pkg = Path(__file__).resolve().parents[1]
    root = root or pkg.parent / "build" / "k1_sweep"
    reports = []
    for i, (block, min_blocks) in enumerate(configs):
        top = root / f"{i}_b{block}_m{min_blocks}"
        shutil.rmtree(top, ignore_errors=True)
        shutil.copytree(pkg, top / pkg.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        for rel, pattern, value in (
                ("csrc/intersect.cu", r"(constexpr int kBlock = )\d+", block),
                ("csrc/intersect.cu",
                 r"(constexpr int kClosestMinBlocks = )\d+", min_blocks),
                ("ops/intersect_kernel.py", r"(?m)^(BLOCK = )\d+", block)):
            path = top / pkg.name / rel
            text, n = re.subn(pattern, rf"\g<1>{value}", path.read_text())
            if n != 1:
                raise RuntimeError(f"{pattern} matches {n} times in {rel}")
            path.write_text(text)
        run = subprocess.run(
            [sys.executable, "-m", f"{pkg.name}.utils.kernel_timing", "--k1"],
            cwd=top, capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"K1 at {block} lanes, {min_blocks} blocks: "
                               f"{run.stderr[-2000:]}")
        reports.append(json.loads(run.stdout.strip().splitlines()[-1]))
    return reports


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=6)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--k1", action="store_true",
                    help="print k1_report alone")
    ap.add_argument("--k1-block-sizes", action="store_true",
                    help="k1_report over K1_SWEEP, in copies of the package")
    ap.add_argument("--spread", action="store_true",
                    help="print spread_sweep of a frame alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a CUDA card")
    from tracer_tpu_torch.ops import cuda_lib, intersect, shapes
    from tracer_tpu_torch.ops import intersect_kernel as ik
    from tracer_tpu_torch.utils import kernel_cases
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    if args.k1_block_sizes:
        print(json.dumps({"k1_block_sizes": k1_block_sizes()}), flush=True)
        return
    ik.build()
    if args.k1:
        print(json.dumps(k1_report(args.size, dev)), flush=True)
        return
    if args.spread:
        from tracer_tpu_torch.engine import integrator
        print(json.dumps(spread_sweep(
            integrator, sub_state(args.levels, args.size, dev))), flush=True)
        return
    s = sub_state(args.levels, args.size, dev)
    co, cb = s.scene.accel.coeffs, s.scene.accel.chunk_bounds
    phi_b, phi_s, st = timed_rays(s)
    hi = shapes.F32_HIGHEST
    box = sub_state(0, args.size, dev)
    box_co, box_cb = box.scene.accel.coeffs, box.scene.accel.chunk_bounds
    # the box's any-hit queries are not sorted (one chunk: perm="auto" off)
    _, _, (so, sd, box_st) = kernel_cases.render_rays(box)
    box_phi = intersect.ray_features_t(so, sd)
    print(json.dumps({
        "levels": args.levels, "size": args.size,
        "build_s": cuda_lib.build_info()["seconds"],
        "k1_block": ik.BLOCK, "k2_block": ik.STREAMED_CLOSEST_BLOCK,
        "k3_block": ik.ANY_BLOCK, "k4_block": ik.STREAMED_ANY_BLOCK,
        "closest_hit_streamed": kernel_times("closest", co, phi_b, hi, cb,
                                             True),
        "any_hit_streamed": kernel_times("any", co, phi_s, st, cb, True),
        "any_hit": kernel_times("any", co, phi_s, st, cb, False),
        "any_hit_cornell": kernel_times("any", box_co, box_phi, box_st,
                                        box_cb, False),
        "k2_scans": k2_scans(co, phi_b, hi, cb),
        "k4_scans": k4_scans(co, phi_s, st, cb),
        "k2_vs_exact": closest_vs_exact(co, phi_b, hi, cb, True),
        "k2_block_order": k2_block_order(co, phi_b, hi, cb),
        "k4_vs_exact": any_vs_exact(co, phi_s, st, cb, True),
        "k3_vs_exact": any_vs_exact(co, phi_s, st, cb, False),
        "k3_vs_exact_cornell": any_vs_exact(box_co, box_phi, box_st, box_cb,
                                            False),
        "stream_pairs": stream_pairs(args.size, dev,
                                     states={args.levels: s}),
        "k1": k1_report(args.size, dev, sub6=s if args.levels == 6 else None),
    }), flush=True)


if __name__ == "__main__":
    main()
