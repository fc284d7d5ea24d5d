"""Device operations (kernels, copies, fills) the profiled call ran,
over its pool iterations: the host's dispatch per bounce. Offline
entries, traced runs."""


def read(run):
    if run.kind == "frames" or not run.trace.get("iters") \
            or not run.trace["device_ops"]:
        return None
    return run.trace["device_ops"] / run.trace["iters"]
