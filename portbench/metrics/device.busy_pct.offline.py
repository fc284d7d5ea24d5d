"""Percent of the profiled call's host-clock wall in which the card ran
an operation (the union of its activity intervals). A lower bound: the
profiler lengthens the wall. Offline entries, traced runs."""


def read(run):
    if run.kind == "frames" or not run.trace.get("busy_s"):
        return None
    return 100.0 * run.trace["busy_s"] / run.trace["window_s"]
