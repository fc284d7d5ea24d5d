"""Percent of the pool's lane-iterations that traced a live path in the
profiled call: 100 x pool.live_lanes / pool.lane_iters, the program's
own counters (utils/profiling; render_pooled adds rays_traced / 3 and
lanes x iters after its one read). Offline entries, traced runs; None
where the program records no such counters."""

from portbench import program


def read(run):
    return program.live_pct(run, "offline")
