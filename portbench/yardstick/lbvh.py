"""The least time the card could take over the LBVH walks of a traced
call, and the share of it the walks' kernels reach.

Bytes only: a walk of any order reads every triangle of the tree at
least once over a query (TRI_BYTES each), and each lane's tmax, and
writes its answer (ANSWER_BYTES: the leaf and t, or the hit flag). The
counts are the program's own counters over the profiled call
(query.tris.<kernel>: the tree's triangles at each launch;
query.lanes.<kernel>: each launch's lanes), through program.recorded.
No operations are counted, nor a ray's bytes: those need the rays of the
queries, which only the taps of drive.tap_queries give, and the taps do
not reach the LBVH. So the bound is a floor, well below what the walk
needs.

The time spent is the device seconds of the traced breakdown's device
ops whose name holds the kernel's function name (KERNEL_NAMES), as the
profiler names the hand kernel; None where no such op is among them.
"""

from __future__ import annotations

from portbench import program
from portbench.yardstick.roofline import ANSWER_BYTES, TMAX_BYTES, TRI_BYTES
from portbench.yardstick.roofline import peaks as card_peaks

# the query kind -> the kernel's name in the program's counters, and the
# function name the profiler reports for it (tracer_tpu_torch/csrc/bvh.cu)
COUNTER_NAMES = {"closest": "lbvh_closest", "any": "lbvh_any"}
KERNEL_NAMES = {"closest": "lbvh_closest_kernel", "any": "lbvh_any_kernel"}


def moved_bytes(counters: dict, query: str):
    """The bytes the walks of one kind must move over the counted
    launches, None where the program counted none."""
    name = COUNTER_NAMES[query]
    lanes = counters.get("query.lanes." + name)
    tris = counters.get("query.tris." + name)
    if not lanes or not tris:
        return None
    return TRI_BYTES * tris + (TMAX_BYTES + ANSWER_BYTES[query]) * lanes


def bound_s(run, query: str):
    """The least seconds of the profiled call's walks of one kind, or
    None."""
    got = program.recorded(run, "offline")
    rates = card_peaks(run.card)
    if got is None or rates is None:
        return None
    moved = moved_bytes(got[0], query)
    return None if moved is None else moved / rates["hbm_bytes_per_s"]


def spent_s(run, query: str):
    """Device seconds of the kernel's ops in the traced breakdown, or
    None."""
    ops = run.trace.get("breakdown", {}).get("device_ops", [])
    secs = [s for name, s in ops if KERNEL_NAMES[query] in name]
    return sum(secs) if secs else None


def roofline_pct(run, query: str):
    """100 x bound_s / spent_s, or None where either is missing."""
    bound, spent = bound_s(run, query), spent_s(run, query)
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
