"""Host microseconds per call that rank 0 spends in collectives over the
chains axis: the traced window's ``collective`` spans (the stop test's
all-reduce, enqueued and read back, which holds rank 0 until the
slowest card has reached it) over its ``call`` spans (the program's
spans, :mod:`program_spans`).  A program or cell without such spans has
nothing to read."""

import program_spans


def read(w):
    rows = program_spans.load()
    if not rows:
        return None
    n, calls = (program_spans.count(rows, name)
                for name in ("collective", "call"))
    if not n or not calls:
        return None
    return 1e3 * program_spans.host_ms(rows, "collective") / calls
