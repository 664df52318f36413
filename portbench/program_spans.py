"""The program's spans of a traced window, as the per-layer readers take
them.

The fused engine records spans at the boundaries of its host loop
(``walnuts_tpu_torch.utils.trace``: ``call``, ``pack``, ``period``,
``readback``, ``launch``, ``capture``, ``summarize``, ``consensus``,
``unpack``) while ``torch.profiler`` runs, so a ``--trace 1`` window
leaves the spans of its calls.  A span is ``(name, parent index, start
ns, end ns, device us or None)`` on the host's wall clock.  A program
that records no spans, or a window without the profiler, leaves none,
and every reader of them then finds nothing to read.
"""


def load():
    """The window's spans, or None where the program recorded none."""
    try:
        from walnuts_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    return trace.spans() or None


def host_ms(rows, name):
    """Host milliseconds in the spans named ``name``."""
    return 1e-6 * sum(t1 - t0 for n, _, t0, t1, _ in rows if n == name)


def count(rows, name):
    """The number of spans named ``name``."""
    return sum(1 for r in rows if r[0] == name)


def launched_periods(rows):
    """``(readback, launch, capture ns)`` for each ``period`` that holds
    a launch: its stop test's ``readback`` span, its ``launch`` span and
    the host nanoseconds of the ``capture`` spans inside that launch."""
    kids = {}
    for i, r in enumerate(rows):
        kids.setdefault(r[1], []).append(i)
    out = []
    for i, r in enumerate(rows):
        if r[0] != "period":
            continue
        mine = {rows[j][0]: j for j in kids.get(i, ())}
        if "launch" not in mine:
            continue
        launch = mine["launch"]
        captured = sum(rows[j][3] - rows[j][2] for j in kids.get(launch, ())
                       if rows[j][0] == "capture")
        out.append((rows[mine["readback"]], rows[launch], captured))
    return out
