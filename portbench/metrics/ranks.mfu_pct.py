"""Every rank's share of its card's peak: the gradient evaluations'
float operations of all the ranks in the window (portbench/roofline.py)
over the window's wall time, against the cell's cards times the vector
float peak of the configuration's precision.  A window whose entry
reports no ranks has nothing to read."""

import roofline


def read(w):
    if not getattr(w, "ranks", None) or not w.grads:
        return None
    ops, _ = roofline.work(w.C, w.D, w.itemsize, w.dg, w.grads,
                           w.transitions, w.config["flops_per_coord"])
    peak = int(w.cell.chips) * roofline.FLOP_S[w.dtype]
    return 100.0 * ops / w.window_s / peak
