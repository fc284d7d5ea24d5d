"""Percent of the wall of eight profiled frames in which the card ran an
operation. A lower bound, as device.busy_pct.offline. The viewer,
traced runs."""


def read(run):
    if run.kind != "frames" or not run.trace.get("busy_s"):
        return None
    return 100.0 * run.trace["busy_s"] / run.trace["window_s"]
