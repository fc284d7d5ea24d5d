"""Host milliseconds per pool iteration that the profiled call spends
preparing its sorted queries, from the program's spans
(utils/profiling): the self seconds of query.sort (the key, the stable
sort, the gather, the scatter back and the kernel wrapper's dispatch,
with the schedule's span inside it) and the seconds of query.schedule
(the per-tile superchunk schedule), over the call's pool iterations.
Offline entries, traced runs; None where no query sorted (a scene of
one chunk) or the program records no query.sort span."""

from portbench import program


def read(run):
    got = program.recorded(run, "offline")
    if got is None or "query.sort" not in got[1]:
        return None
    s = got[1]
    prep = s["query.sort"]["self_s"] + program.total_s(s, "query.schedule")
    return 1e3 * prep / run.trace["iters"]
