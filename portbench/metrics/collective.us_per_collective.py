"""Device microseconds per collective on rank 0: the device time of
rank 0's NCCL kernels in the traced window (names starting with nccl,
torch.profiler) over the collectives the program counted there
(``parallel.mesh.chain_collectives``, the entry's ``w.collectives``).
An NCCL kernel runs from its launch until every rank has joined, so
the time holds the wait for the slowest card.  A program without the
counter, or a window without NCCL kernels, has nothing to read."""

import re

NCCL = re.compile(r"(void\s+)?nccl(Dev)?Kernel")


def read(w):
    n = getattr(w, "collectives", None)
    if w.trace is None or not n:
        return None
    t = sum(s for name, s in w.trace["device_s_by_name"].items()
            if NCCL.match(name))
    return 1e6 * t / n if t else None
