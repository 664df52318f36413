"""Host milliseconds per call in capturing the external-gradient
route's period as a CUDA graph: the traced window's ``capture`` spans
over its ``call`` spans (the program's spans, :mod:`program_spans`)."""

import program_spans


def read(w):
    rows = program_spans.load()
    calls = program_spans.count(rows, "call") if rows else 0
    if not calls:
        return None
    return program_spans.host_ms(rows, "capture") / calls
