"""Percent of the pool's lane-iterations that traced a live path over
the eight profiled frames: 100 x pool.live_lanes / pool.lane_iters, the
program's own counters (utils/profiling). The viewer, traced runs; None
where the program records no such counters."""

from portbench import program


def read(run):
    return program.live_pct(run, "frames")
