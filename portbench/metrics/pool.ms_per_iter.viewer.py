"""Host milliseconds per pool iteration of the viewer's frames: the
window's api.step walls over the iterations render_pooled reports for
them. Traced runs."""


def read(run):
    if run.kind != "frames" or not run.iters:
        return None
    wall = sum(c["step_s"] for c in run.calls)
    return 1e3 * wall / sum(run.iters[:len(run.calls)])
