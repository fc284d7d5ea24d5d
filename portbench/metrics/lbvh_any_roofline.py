"""Percent: the least time the card could take over the LBVH's any-hit
walks of the profiled call (yardstick/lbvh.py: every triangle read once
a query, each lane's tmax read and its hit flag written) over the device
time of K15 (lbvh_any_kernel) in the traced breakdown. Offline entries,
traced runs; None where the program counts no LBVH walk or the kernel is
not among the breakdown's device ops."""

from portbench.yardstick import lbvh


def read(run):
    return lbvh.roofline_pct(run, "any")
