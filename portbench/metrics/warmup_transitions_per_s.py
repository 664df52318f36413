"""Warmup transitions per second: the transitions the chains completed
in the window, summed over chains, over the window's wall time."""


def read(w):
    if not w.run.get("warmup") or not w.transitions:
        return None
    return w.transitions / w.window_s
