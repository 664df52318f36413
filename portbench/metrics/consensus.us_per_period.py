"""Device microseconds per period of the pooled warmup's consensus: the
mean, over the traced window's ``consensus`` spans, of the device time
between the CUDA events each records around the batch median and its
write-back (the program's spans, :mod:`program_spans`)."""

import program_spans


def read(w):
    us = [r[4] for r in program_spans.load() or ()
          if r[0] == "consensus" and r[4] is not None]
    return sum(us) / len(us) if us else None
