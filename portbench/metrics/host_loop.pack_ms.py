"""Host milliseconds per call in packing the engine's state into fresh
banks and unpacking it: the traced window's ``pack`` and ``unpack``
spans over its ``call`` spans (the program's spans,
:mod:`program_spans`)."""

import program_spans


def read(w):
    rows = program_spans.load()
    calls = program_spans.count(rows, "call") if rows else 0
    if not calls:
        return None
    return (program_spans.host_ms(rows, "pack")
            + program_spans.host_ms(rows, "unpack")) / calls
