"""Blocking reads of the card per period: the traced window's
``readback`` spans (the stop test each period, the gradient count at
each call's end) over its periods that launch (the program's spans,
:mod:`program_spans`)."""

import program_spans


def read(w):
    rows = program_spans.load()
    periods = program_spans.launched_periods(rows) if rows else None
    if not periods:
        return None
    return program_spans.count(rows, "readback") / len(periods)
