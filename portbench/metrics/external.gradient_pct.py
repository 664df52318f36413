"""The share of device time outside the round kernel in the traced
window: on the external-gradient route, the target's torch gradient
and the copies between the kernel's segments."""

from devtrace import round_kernel_s


def read(w):
    if w.trace is None:
        return None
    mine, other = round_kernel_s(w.trace)
    return 100.0 * other / (mine + other) if other else None
