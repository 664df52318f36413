"""Flush periods queued per blocking read of the card: the traced
window's ``launch`` and ``ahead`` spans (each turn of the host loop
launches its first period and queues the rest ahead, without a read)
over its ``readback`` spans (the stop test each turn, the gradient count
at each call's end); the program's spans, :mod:`program_spans`.  A
program that reads the stop test after every period, and has no
``ahead`` span, reads just under 1."""

import program_spans


def read(w):
    rows = program_spans.load()
    reads = program_spans.count(rows, "readback") if rows else 0
    if not reads:
        return None
    return (program_spans.count(rows, "launch")
            + program_spans.count(rows, "ahead")) / reads
