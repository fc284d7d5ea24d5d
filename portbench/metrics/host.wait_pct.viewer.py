"""Percent of the eight profiled frames' api.step and api.render in which
the host waited for the card at an explicit read: the seconds of the
program's host.read.* spans over those of its api.* spans
(utils/profiling). Higher: the card sets the pace. The profiler slows
the host, so the share is a lower bound, as device.busy_pct is. The
viewer, traced runs; None where the program records no such spans."""

from portbench import program


def read(run):
    return program.wait_pct(run, "frames")
