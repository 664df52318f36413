"""Wall milliseconds per call of the cell's round cap: the window's wall
over its rounds, times the rounds of one call at the cap (the
benchmark's own span around the calls, ending in
torch.cuda.synchronize; the check's shorter calls count by their
rounds)."""


def read(w):
    return 1e3 * w.window_s * int(w.run["rounds_per_call"]) / w.rounds
