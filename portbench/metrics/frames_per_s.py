"""All the window's frames over the seconds from the window's start to
the last frame's end. The viewer only."""


def read(run):
    if run.kind != "frames" or not run.calls:
        return None
    return len(run.calls) / (run.calls[-1]["t1"] - run.window_start)
