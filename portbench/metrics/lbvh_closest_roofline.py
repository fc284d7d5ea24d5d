"""Percent: the least time the card could take over the LBVH's
closest-hit walks of the profiled call (yardstick/lbvh.py: every
triangle read once a query, each lane's tmax read and its leaf and t
written) over the device time of K14 (lbvh_closest_kernel) in the traced
breakdown. Offline entries, traced runs; None where the program counts
no LBVH walk or the kernel is not among the breakdown's device ops."""

from portbench.yardstick import lbvh


def read(run):
    return lbvh.roofline_pct(run, "closest")
