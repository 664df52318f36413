"""The readers of the program's spans (``metrics/`` over
``program_spans.py``): each gives the value worked out by hand on a
hand-made list of spans, and nothing where the program recorded no
spans or has no span recorder; a traced run of a small cell reports
them."""

import sys
from pathlib import Path

import pytest

import inputs
from test_portbench_harness import last_json, run_cell
from walnuts_tpu_torch.utils import trace
from walnuts_tpu_torch.utils.trace import Span

PORTBENCH = Path(__file__).resolve().parents[1]

# one call: pack; two periods that launch (the first captures a graph),
# each with the consensus; the last period's stop test; unpack with the
# gradient count's read (times in ns)
SPANS = [
    Span("call", -1, 0, 100_000, None),
    Span("pack", 0, 1_000, 3_000, None),
    Span("period", 0, 3_000, 20_000, None),
    Span("readback", 2, 3_000, 5_000, None),
    Span("launch", 2, 6_000, 15_000, None),
    Span("capture", 4, 7_000, 12_000, None),
    Span("consensus", 2, 15_000, 18_000, 4.0),
    Span("period", 0, 20_000, 30_000, None),
    Span("readback", 7, 20_000, 21_000, None),
    Span("launch", 7, 22_000, 24_000, None),
    Span("consensus", 7, 24_000, 27_000, 6.0),
    Span("period", 0, 30_000, 32_000, None),
    Span("readback", 11, 30_000, 31_000, None),
    Span("unpack", 0, 32_000, 40_000, None),
    Span("readback", 13, 33_000, 34_000, None),
]

# by hand: turnaround ((15 - 5 - 5) + (24 - 21)) / 2 us; 4 readbacks over
# 2 launched periods (1 + 2 x 1 call / 2 periods); pack and unpack 2 + 8
# us in 1 call; consensus (4 + 6) / 2 device us; capture 5 us in 1 call
WANT = {
    "host_loop.turnaround_us": 4.0,
    "host_loop.readbacks_per_period": 2.0,
    "host_loop.pack_ms": 0.010,
    "consensus.us_per_period": 5.0,
    "external.capture_ms": 0.005,
}


def _reader(name):
    return inputs.load_module(PORTBENCH / "metrics" / f"{name}.py",
                              "test_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_hand_made_spans(monkeypatch, name):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    assert _reader(name).read(None) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert _reader(name).read(None) is None
    # a program without the span recorder
    monkeypatch.setitem(sys.modules, "walnuts_tpu_torch.utils.trace", None)
    assert _reader(name).read(None) is None


def test_consensus_without_device_events_reads_nothing(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: [
        s._replace(device_us=None) for s in SPANS])
    assert _reader("consensus.us_per_period").read(None) is None


@pytest.mark.parametrize("workload, names", [
    ("tiny_funnel.sample", ("host_loop.turnaround_us",
                            "host_loop.readbacks_per_period",
                            "host_loop.pack_ms")),
    ("tiny_funnel.warmup", ("host_loop.turnaround_us.warmup",
                            "host_loop.readbacks_per_period.warmup",
                            "host_loop.pack_ms.warmup")),
])
def test_traced_run_reports_the_span_metrics(tiny_root, workload, names):
    p = run_cell(tiny_root, workload, seed=2 ** 31 + 5, seconds=2.0, trace=1)
    assert p.returncode == 0, p.stderr[-3000:]
    got = last_json(p.stdout)["metrics"]
    for name in names:
        assert got[name]["value"] > 0, name
    # every call reads the stop test once more than it launches, and the
    # gradient count once
    assert got[names[1]]["value"] > 1.0
    # on the CPU the consensus records no device time
    assert "consensus.us_per_period" not in got
