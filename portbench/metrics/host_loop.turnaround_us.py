"""Host microseconds from learning that the card is done to queuing its
next work: over the traced window's periods that launch, the mean of
the end of the period's ``launch`` span less the end of its stop test's
``readback`` span, less any graph ``capture`` inside that launch (the
program's spans, :mod:`program_spans`)."""

import program_spans


def read(w):
    rows = program_spans.load()
    periods = program_spans.launched_periods(rows) if rows else None
    if not periods:
        return None
    return 1e-3 * sum(launch[3] - readback[3] - captured
                      for readback, launch, captured in periods
                      ) / len(periods)
