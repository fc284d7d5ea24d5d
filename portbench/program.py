"""What the program recorded of a traced run's profiled stretch: the
counters and the span summary of tracer_tpu_torch.utils.profiling, whose
recorder is on exactly while the profiler records (one call; eight frames
of the viewer).

A reader of a per-layer metric takes them through recorded(), which
gives None where there is nothing to read: an untraced run, an entry of
another kind, a program that has no recorder, or a recorder whose
pool.iters is not the iteration count of the traced stretch (then it did
not record that stretch alone).
"""

from __future__ import annotations


def recorded(run, kind: str):
    """(counters, summary) of the traced stretch of a run whose entry is
    of `kind` ("offline" or "frames"), or None."""
    if run.kind != kind or not run.trace.get("iters"):
        return None
    try:
        from tracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    summary = getattr(profiling, "summary", None)
    if counters is None or summary is None:
        return None
    c = counters()
    if c.get("pool.iters") != run.trace["iters"]:
        return None
    return c, summary()


def total_s(summary: dict, prefix: str) -> float:
    """Seconds of every span whose name starts with prefix (spans of one
    prefix do not nest in each other)."""
    return sum(v["total_s"] for k, v in summary.items()
               if k.startswith(prefix))


def live_pct(run, kind: str):
    """100 x pool.live_lanes / pool.lane_iters: the share of the pool's
    lane-iterations that traced a live path."""
    got = recorded(run, kind)
    if got is None or not got[0].get("pool.lane_iters"):
        return None
    c = got[0]
    return 100.0 * c.get("pool.live_lanes", 0) / c["pool.lane_iters"]


def wait_pct(run, kind: str):
    """100 x the seconds of the host.read.* spans over those of the
    api.* spans: the share of the calls in which the host waited for the
    card at an explicit read."""
    got = recorded(run, kind)
    if got is None:
        return None
    api = total_s(got[1], "api.")
    if not api:
        return None
    return 100.0 * total_s(got[1], "host.read.") / api
