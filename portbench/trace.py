"""torch.profiler over a stretch of calls, reduced to what the per-layer
metrics and the breakdown read.

The profiler records the host's ops and the card's activity (CPU and
CUDA: tracing the card alone once lost a render's first kernels). The
card is busy over the union of its activity intervals, each counted
once; the share is of the host-clock wall of the profiled stretch, which
the profiler's own host cost lengthens, so the share is a lower bound.
"""

from __future__ import annotations

import time

QUERY_OPS = {"closest": "tracer_tpu_torch::closest_hit",
             "any": "tracer_tpu_torch::any_hit"}
TOP = 10
NAME_CHARS = 160       # a device op's name is cut to this in the breakdown
PROFILER_OWN = ("Activity Buffer Request",)
# NCCL's kernels (ncclDevKernel_AllReduce_Sum_f32_RING_LL, or ncclKernel_...
# before NCCL 2.19); not c10d's device annotation "nccl:all_reduce" that
# mirrors each of them
COLLECTIVE_KERNELS = ("ncclDevKernel", "ncclKernel")
ALIGN = "portbench.align"   # the ranks' barrier before a profiled stretch


def union(spans):
    """[(start, end)] merged, from intervals in any order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profiled(fn, sync, align=None):
    """Run fn() under the profiler; returns (profiler, wall seconds).
    align: a barrier of the cell's ranks, run under the profiler in a span
    of its own (ALIGN) before fn, so that the ranks' starts of the
    profiler, whose cost varies from rank to rank, are waited for there
    and not in fn's first collective. reduce() leaves it out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if align is not None:
            with record_function(ALIGN):
                align()
                sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return prof, wall


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def reduce(prof, wall: float) -> dict:
    """busy_s, window_s, the device ops counted, each query op's device
    seconds (the kernels launched inside its outermost host events, its
    own and its children's), the device seconds of NCCL's kernels
    (collective_s: ops whose name begins with one of COLLECTIVE_KERNELS),
    and the breakdown: the TOP device ops by time and the TOP longest
    idle gaps of the card, each named by the innermost host op running
    at the gap's middle ("python" where none was). Device ops that ended
    before the ALIGN span closed ran before the stretch and are left out.
    Reads the profiler's raw events, not its event tree."""
    import bisect

    import numpy as np
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.linked_correlation_id(), e.name()))
        elif e.device_type() == DeviceType.CPU and \
                e.name() not in PROFILER_OWN:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.correlation_id(), e.name()))
    cut = max((b for _, b, _, n in host if n == ALIGN), default=None)
    if cut is not None:
        dev = [d for d in dev if d[1] > cut]
    merged = union((a, b) for a, b, _, _ in dev)
    busy_ns = sum(b - a for a, b in merged)

    by_name = {}
    for a, b, _, name in dev:
        by_name[name] = by_name.get(name, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    op_s = {}
    for q, op in QUERY_OPS.items():
        spans = union((a, b) for a, b, _, n in host if n == op)
        starts = [a for a, _ in spans]
        inside = set()
        for a, _, corr, _ in host:
            k = bisect.bisect_right(starts, a) - 1
            if k >= 0 and a <= spans[k][1]:
                inside.add(corr)
        op_s[q] = sum(b - a for a, b, link, _ in dev if link in inside) * 1e-9

    collective_ns = sum(b - a for a, b, _, name in dev
                        if name.startswith(COLLECTIVE_KERNELS))

    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    if host:
        h_start = np.array([h[0] for h in host], np.int64)
        h_end = np.array([h[1] for h in host], np.int64)
    named = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        name = "python"
        if host:
            cover = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
            if cover.size:
                k = cover[np.argmin(h_end[cover] - h_start[cover])]
                name = host[k][3]
        named.append([name, length * 1e-9])
    return {"busy_s": busy_ns * 1e-9, "window_s": wall,
            "device_ops": len(dev), "op_device_s": op_s,
            "collective_s": collective_ns * 1e-9,
            "breakdown": {"device_ops": [[_short(k), v * 1e-9]
                                         for k, v in top],
                          "idle_gaps": named}}
