"""The round kernel's share of its work-counted roofline: the least time
an H100 needs for the window's work (portbench/roofline.py: the
gradient evaluations' operations, the draws and the chains' state
bytes) over the device time of the kernels whose names start with
round_kernel in the traced window."""

import roofline
from devtrace import round_kernel_s


def read(w):
    if w.trace is None:
        return None
    t, _ = round_kernel_s(w.trace)
    if not t or not w.grads:
        return None
    ops, nbytes = roofline.work(w.C, w.D, w.itemsize, w.dg, w.grads,
                                w.transitions, w.config["flops_per_coord"])
    return 100.0 * roofline.bound_s(ops, nbytes, w.dtype) / t
