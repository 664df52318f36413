"""The reader of ``host_loop.periods_per_readback`` (``metrics/`` over
``program_spans.py``) on hand-made spans: a call of one turn that queues
three periods ahead of its first, a program that reads the stop test
after every period (no ``ahead`` span), and none without spans or
without a span recorder; a traced run of a small cell reports it."""

import sys
from pathlib import Path

import pytest

import inputs
from test_portbench_harness import last_json, run_cell
from walnuts_tpu_torch.utils import trace
from walnuts_tpu_torch.utils.trace import Span

PORTBENCH = Path(__file__).resolve().parents[1]
NAME = "host_loop.periods_per_readback"

# one call of one turn: its stop test, a launch and three periods queued
# ahead, then the gradient count's read (times in ns)
TURN = [
    Span("call", -1, 0, 100_000, None),
    Span("pack", 0, 1_000, 3_000, None),
    Span("period", 0, 3_000, 40_000, None),
    Span("readback", 2, 3_000, 5_000, None),
    Span("launch", 2, 6_000, 15_000, None),
    Span("ahead", 2, 15_000, 20_000, None),
    Span("ahead", 2, 20_000, 25_000, None),
    Span("ahead", 2, 25_000, 30_000, None),
    Span("unpack", 0, 40_000, 50_000, None),
    Span("readback", 8, 41_000, 42_000, None),
]

# the same call read period by period: two periods, each after its stop
# test, the stop test once more, the gradient count
PER_PERIOD = [
    Span("call", -1, 0, 100_000, None),
    Span("period", 0, 3_000, 20_000, None),
    Span("readback", 1, 3_000, 5_000, None),
    Span("launch", 1, 6_000, 15_000, None),
    Span("period", 0, 20_000, 30_000, None),
    Span("readback", 4, 20_000, 21_000, None),
    Span("launch", 4, 22_000, 24_000, None),
    Span("period", 0, 30_000, 32_000, None),
    Span("readback", 7, 30_000, 31_000, None),
    Span("unpack", 0, 32_000, 40_000, None),
    Span("readback", 9, 33_000, 34_000, None),
]


def _reader():
    return inputs.load_module(PORTBENCH / "metrics" / f"{NAME}.py",
                              "test_reader_periods_per_readback")


@pytest.mark.parametrize("spans, want", [(TURN, 4 / 2), (PER_PERIOD, 2 / 4)],
                         ids=["turn", "per_period"])
def test_reader_on_hand_made_spans(monkeypatch, spans, want):
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    assert _reader().read(None) == pytest.approx(want, rel=1e-12)


def test_reader_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert _reader().read(None) is None
    # a program without the span recorder
    monkeypatch.setitem(sys.modules, "walnuts_tpu_torch.utils.trace", None)
    assert _reader().read(None) is None


@pytest.mark.parametrize("workload, name, least", [
    # calls of several periods: each queues them in one turn, then reads
    # its gradient count
    ("tiny_funnel.sample", NAME, 2.0),
    # the pooled check's calls of one period read twice each
    ("tiny_funnel.warmup", NAME + ".warmup", 0.5),
])
def test_traced_run_reports_it(tiny_root, workload, name, least):
    p = run_cell(tiny_root, workload, seed=2 ** 31 + 9, seconds=2.0, trace=1)
    assert p.returncode == 0, p.stderr[-3000:]
    got = last_json(p.stdout)["metrics"]
    assert got[name]["value"] >= least
