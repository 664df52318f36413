"""Device microseconds per launch of the round kernel: the device time
of the kernels whose names start with round_kernel in the traced window
(torch.profiler) over the launches the program counted
(round_kernel.launches plus segment_launches)."""

from devtrace import round_kernel_s


def read(w):
    if w.trace is None:
        return None
    n = w.launches + w.segment_launches
    t, _ = round_kernel_s(w.trace)
    return 1e6 * t / n if n and t else None
