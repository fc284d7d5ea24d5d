"""Host milliseconds a profiled frame spends in the API outside the
pool's iterations: (api.step + api.render - pool.iter) seconds over the
count of api.step, from the program's spans (utils/profiling): the
pool's set-up, exit tests and merge, the frame's EMA and the ARGB
packing. The viewer, traced runs; None where the program records no such
spans."""

from portbench import program


def read(run):
    got = program.recorded(run, "frames")
    if got is None:
        return None
    s = got[1]
    steps = s.get("api.step", {}).get("count")
    if not steps:
        return None
    inside = sum(s.get(k, {}).get("total_s", 0.0)
                 for k in ("api.step", "api.render"))
    return 1e3 * (inside - s.get("pool.iter", {}).get("total_s", 0.0)) \
        / steps
