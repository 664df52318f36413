"""Gradient evaluations per second: the exact int64 sum over chains of
the evaluations the window made (the engine's per-chain counts) over
the window's wall time."""


def read(w):
    return w.grads / w.window_s if w.grads else None
