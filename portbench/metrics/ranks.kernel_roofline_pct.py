"""Rank 0's round kernel against its work-counted roofline: the least
time an H100 needs for rank 0's own work in the window (its gradient
evaluations, draws and chains, ``w.ranks[0]``; portbench/roofline.py)
over the device time of rank 0's kernels whose names start with
round_kernel in the traced window.  A window whose entry reports no
ranks has nothing to read."""

import roofline
from devtrace import round_kernel_s


def read(w):
    ranks = getattr(w, "ranks", None)
    if w.trace is None or not ranks:
        return None
    grads, transitions, C = ranks[0]
    t, _ = round_kernel_s(w.trace)
    if not t or not grads:
        return None
    ops, nbytes = roofline.work(C, w.D, w.itemsize, w.dg, grads,
                                transitions, w.config["flops_per_coord"])
    return 100.0 * roofline.bound_s(ops, nbytes, w.dtype) / t
