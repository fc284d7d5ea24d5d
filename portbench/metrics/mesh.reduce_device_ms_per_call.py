"""Device milliseconds of NCCL's kernels (ncclDevKernel_*) per card in
the profiled call, the mean over the cell's ranks (trace.reduce's
collective_s, reduced in run.traced): the all-reduces of
parallel/render.py, the points' closest-return merge over the sample
group and the frame's assembly over the whole group. A collective's
kernel starts once its rank has queued it and ends once every rank's
data has arrived, so besides the transfer (8.6 MB a card a call at
640x480) it holds each rank's wait for the slowest: the mean reads the
mesh's imbalance whichever tile is the slower. The ranks start the call
from a barrier (trace.profiled's align), so the profiler's start is not
in it. Offline entries, traced runs; None where the call launched no
NCCL kernel (one card, or gloo)."""


def read(run):
    if run.kind == "frames" or not run.trace.get("collective_s"):
        return None
    return 1e3 * run.trace["collective_s"]
