"""The whole step's share of the card's peak: the gradient evaluations'
float operations in the window (portbench/roofline.py) over the
window's wall time, against the vector float peak of the configuration's
precision."""

import roofline


def read(w):
    if not w.grads:
        return None
    ops, _ = roofline.work(w.C, w.D, w.itemsize, w.dg, w.grads,
                           w.transitions, w.config["flops_per_coord"])
    return 100.0 * ops / w.window_s / roofline.FLOP_S[w.dtype]
