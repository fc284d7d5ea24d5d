"""Percent of the profiled call in which the host waited for the card at
an explicit read: the seconds of the program's host.read.* spans (the
pool's exit tests and its counts) over those of its api.* spans
(utils/profiling). Higher: the card, not the host's dispatch, sets the
pace. The profiler slows the host 1.6-2.2 times, so the share is a lower
bound, as device.busy_pct is. Offline entries, traced runs; None where
the program records no such spans."""

from portbench import program


def read(run):
    return program.wait_pct(run, "offline")
