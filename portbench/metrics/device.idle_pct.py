"""The card's idle share of the traced window: one minus the union of
device activity (torch.profiler) over the window's wall time."""


def read(w):
    if w.trace is None or not w.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
