"""Mean host milliseconds from a frame's step to its pixels on the host:
api.render -> .cpu() -> argb_to_rgb, over the window's frames. The
viewer, traced runs."""


def read(run):
    if run.kind != "frames" or not run.trace or not run.calls:
        return None
    return 1e3 * sum(c["present_s"] for c in run.calls) / len(run.calls)
