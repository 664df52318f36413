"""Spans of the port's host work, on the clock of the device trace.

A span is one timed interval of host work with a name, opened with
``with span(name):``.  Spans nest: each records the index of the span
open around it, so the spans of one call of the fused engine all have
its ``call`` span as an ancestor.  The fused engine's host loop
(``sampler.megakernel._run``) opens them at its boundaries:

- ``call``: the whole call after its argument checks;
- ``pack``: the fresh banks (``round_kernel.pack``), with the ring a
  deferred summary copies;
- ``period``: one turn of the loop: the stop test read once, then
  every flush period it cannot yet end queued; a turn whose test ends
  the run launches nothing;
- ``readback``: a blocking read of the card (the stop test each turn,
  the gradient count at the end);
- ``launch``: the turn's first period queued (``round_kernel.run_rounds``);
- ``ahead``: each later period of the turn queued, without a read;
- ``capture``: inside ``launch``, a period of external-gradient
  segments captured as a CUDA graph;
- ``summarize``: a deferred summary mapped over the staged draws;
- ``consensus``: the pooled warmup's batch median written back, with
  its device time;
- ``unpack``: the graphs freed, the state unpacked and its gradient
  count read back.

Spans are recorded while ``torch.profiler`` runs (the flag
``torch.autograd.profiler._is_profiler_enabled``), or after
``enable(True)``; ``enable(False)`` keeps them off whatever the
profiler does, and ``enable(None)`` makes them follow it again.  Off,
:func:`span` returns one shared object that does nothing: no clock
read, no allocation.  On, a span is stamped with ``time.time_ns()``,
the wall clock on which kineto stamps its host events, so the spans
and a profiler trace of the same run share one time axis.  They are
kept in memory only (:func:`spans`, :func:`reset`), never added to the
profiler's trace: a ``torch.profiler.record_function`` range costs
microseconds even with no profiler running, and under a CUDA profiler
it adds annotations to the device's timeline.

Spans are recorded for one thread: the engine's host loop runs in the
caller's.
"""

import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 20  # spans kept until reset(); later ones are only counted


class Span(NamedTuple):
    name: str
    parent: int                 # index of the enclosing span; -1 for none
    t0_ns: int                  # time.time_ns() at its start
    t1_ns: Optional[int]        # at its end; None while it is open
    device_us: Optional[float]  # device time between its CUDA events


_forced = None  # True or False after enable(); None follows the profiler
_rows = []      # [name, parent, t0_ns, t1_ns, (start, end) CUDA events]
_open = []      # indices of the open spans, innermost last
dropped = 0     # spans not kept: CAP were kept already


def enable(on: Optional[bool]):
    """Record spans (True), record none (False), or record them while
    ``torch.profiler`` runs (None, the default)."""
    global _forced
    _forced = on


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "row")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        global dropped
        self.row = None
        if len(_rows) >= CAP:
            dropped += 1
            return self
        self.row = [self.name, _open[-1] if _open else -1, time.time_ns(),
                    None, None]
        if self.device:
            self.row[4] = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.row[4][0].record()
        _open.append(len(_rows))
        _rows.append(self.row)
        return self

    def __exit__(self, *exc):
        if self.row is not None:
            if self.row[4] is not None:
                self.row[4][1].record()
            self.row[3] = time.time_ns()
            _open.pop()
        return False


def span(name: str, device: bool = False):
    """A context that records the span ``name`` when spans are on (see
    the module's docstring).  With ``device``, which the caller sets
    when the span's work is queued on the current CUDA stream, the span
    also records a CUDA event there at each end."""
    on = _profiler._is_profiler_enabled if _forced is None else _forced
    return _Span(name, device) if on else _OFF


def spans():
    """Every span recorded since :func:`reset`, as :class:`Span`, in the
    order they opened (a parent before its children).  A span with CUDA
    events gets the device microseconds between them: call this after
    the card has finished its work (``torch.cuda.synchronize()``)."""
    return [Span(name, parent, t0, t1,
                 None if ev is None else 1e3 * ev[0].elapsed_time(ev[1]))
            for name, parent, t0, t1, ev in _rows]


def reset():
    """Forget every recorded span and the count of dropped ones.  Call it
    between runs, not inside a span."""
    global dropped
    _rows.clear()
    _open.clear()
    dropped = 0
