"""The 90th percentile (nearest rank) of all the window's frame times in
ms: step -> render -> .cpu() -> argb_to_rgb, host clock. The viewer
only."""

import math


def read(run):
    if run.kind != "frames" or not run.calls:
        return None
    ms = sorted((c["t1"] - c["t0"]) * 1e3 for c in run.calls)
    return ms[math.ceil(0.9 * len(ms)) - 1]
