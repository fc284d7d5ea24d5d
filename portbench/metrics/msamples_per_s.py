"""Millions of pixel-samples completed by the window's whole calls (width
x height x spp each), over the seconds from the window's start to the
last call's end. Offline entries only."""


def read(run):
    if run.kind == "frames" or not run.calls:
        return None
    seconds = run.calls[-1]["t1"] - run.window_start
    return len(run.calls) * run.samples_per_call / seconds / 1e6
