"""Host milliseconds per pool iteration: the window's unprofiled calls'
walls over the iterations render_pooled reports for them. Offline
entries, traced runs."""


def read(run):
    if run.kind == "frames" or not run.iters:
        return None
    wall = sum(c["t1"] - c["t0"] for c in run.calls)
    return 1e3 * wall / sum(run.iters[:len(run.calls)])
