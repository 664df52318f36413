"""Spans of the fused engine's host loop (``walnuts_tpu_torch.utils.trace``).

On the CPU, at funnel(7), C = 16, m = 4, float64, 64 rounds: off, the
engine reads no clock and records nothing; on, its outputs are bit for
bit the same and the spans form the call's tree (one ``call``, ``pack``
and ``unpack``, a ``period`` per turn of the loop: its stop test's
``readback``, a ``launch`` and an ``ahead`` for each later flush period
the turn queues, a ``consensus`` for each flush period under pooled
warmup; a run to its stop ends in a turn that only reads); under
``torch.profiler`` they turn on by themselves and lie on its clock.
One case, marked ``cuda``, holds the external-gradient route's spans to
the card's trace.  The file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_trace.py
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import walnuts_tpu_torch as tw
from walnuts_tpu_torch.sampler import megakernel as mk
from walnuts_tpu_torch.sampler import round_kernel as rk
from walnuts_tpu_torch.utils import trace

torch.set_num_threads(2)

C, D, M, ROUNDS = 16, 7, 4, 64
PERIODS = ROUNDS // mk.FLUSH_EVERY
Q0 = 0.3 * np.random.default_rng(0).normal(size=(C, D))
POOLED = dict(warmup_iter=20, pooled=True)


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.reset()
    trace.enable(None)
    yield
    trace.enable(None)
    trace.reset()


def _run(warmup=None, num_iter=1000, rounds=ROUNDS):
    return tw.run_walnuts_fused(
        12345, torch.from_numpy(Q0), torch.full((C,), 0.4, dtype=torch.float64),
        torch.full((C,), 0.15, dtype=torch.float64),
        target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=M),
        warmup=None if warmup is None else tw.WarmupConfig(**warmup),
        num_iter=num_iter, rounds=rounds, device="cpu")


def _flat(x):
    """Every tensor and number of a run's outputs, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _periods(spans):
    """The names of each ``period`` span's children, period by period."""
    kids = {i: [] for i, s in enumerate(spans) if s.name == "period"}
    for s in spans:
        if s.parent in kids:
            kids[s.parent].append(s.name)
    return [kids[i] for i in sorted(kids)]


@pytest.mark.parametrize("how", ["default", "forced_off_under_profiler"])
def test_off_reads_no_clock_and_records_nothing(monkeypatch, how):
    reads = []
    real = trace.time.time_ns
    monkeypatch.setattr(trace.time, "time_ns",
                        lambda: reads.append(1) or real())
    if how == "default":
        _run()
        _run(POOLED)
    else:
        trace.enable(False)
        with profile(activities=[ProfilerActivity.CPU]):
            _run()
    assert not reads
    assert trace.spans() == []


@pytest.mark.parametrize("warmup", [None, POOLED], ids=["fixed", "pooled"])
def test_outputs_equal_with_spans_on_and_off(warmup):
    off = _flat(_run(warmup))
    trace.enable(True)
    on = _flat(_run(warmup))
    assert trace.spans()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_spans_form_the_call_tree():
    trace.enable(True)
    _run()
    spans = trace.spans()
    names = Counter(s.name for s in spans)
    assert (names["call"], names["pack"], names["unpack"]) == (1, 1, 1)
    # the rounds cap ends the call in one turn: its one stop test proves
    # every period live, and the cap is known without a read
    periods = _periods(spans)
    assert periods == [["readback", "launch"] + ["ahead"] * (PERIODS - 1)]
    assert names["readback"] == 2
    assert names["launch"] + names["ahead"] == PERIODS
    assert "capture" not in names
    assert spans[0].name == "call" and spans[0].parent == -1
    for i, s in enumerate(spans):
        assert s.t0_ns <= s.t1_ns and s.device_us is None
        if i:
            p = spans[s.parent]
            assert s.parent < i and p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    parents = {(s.name, spans[s.parent].name) for s in spans[1:]}
    assert parents == {("pack", "call"), ("period", "call"),
                       ("readback", "period"), ("launch", "period"),
                       ("ahead", "period"), ("unpack", "call"),
                       ("readback", "unpack")}


def test_a_run_to_its_stop_ends_in_a_turn_that_only_reads():
    """Without a rounds cap the stop test ends the call: every turn but
    the last launches, each turn queues the periods its read proves
    live, and the last reads the stop and launches nothing."""
    trace.enable(True)
    mk.stop_readbacks = 0
    out = _run(num_iter=6, rounds=None)
    spans = trace.spans()
    periods = _periods(spans)
    assert len(periods) == mk.stop_readbacks >= 3
    assert periods[-1] == ["readback"]
    for p in periods[:-1]:
        assert p[:2] == ["readback", "launch"] and set(p[2:]) <= {"ahead"}
    assert int(out[3].min()) >= 6
    launched = sum(len(p) - 1 for p in periods)
    assert launched > len(periods)


def test_pooled_warmup_holds_a_consensus_in_each_launched_period():
    trace.enable(True)
    _run(POOLED)
    periods = _periods(trace.spans())
    assert [p.count("consensus") for p in periods] == [PERIODS]
    assert [p.count("launch") + p.count("ahead") for p in periods] == [
        PERIODS]
    assert all(s.device_us is None for s in trace.spans())


def test_profiler_turns_spans_on_and_shares_their_clock(monkeypatch):
    real = rk.run_rounds

    def marked(*args):
        with record_function("test.launch"):
            real(*args)

    monkeypatch.setattr(rk, "run_rounds", marked)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run()
    # the turn's launch, then its periods queued ahead, in order
    launches = [s for s in trace.spans() if s.name in ("launch", "ahead")]
    assert [s.name for s in launches] == ["launch"] + ["ahead"] * (
        PERIODS - 1)
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()]
    marks = sorted(e for e in events if e[2] == "test.launch")
    assert len(marks) == PERIODS
    for (m0, m1, _), s in zip(marks, launches):
        inside = [e for e in events if e[2].startswith("aten::")
                  and m0 <= e[0] and e[1] <= m1]
        assert inside
        for e0, e1, _ in inside:
            assert s.t0_ns - 10 ** 6 <= e0 and e1 <= s.t1_ns + 10 ** 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_external_route_spans_on_the_card(cuda_device):
    """Funnel(11) as a user's density: each call captures its period's
    graph once, inside a ``launch``, and every segment that period
    queued starts on the card after that ``launch`` began."""
    f = tw.targets.funnel(11)
    user = tw.Target(f._logp, f.dim, name="funnel_user",
                     logp_grad=f._logp_grad)
    Cc, unroll, calls = 256, 1, 2
    g = torch.Generator().manual_seed(3)
    q0 = (0.3 * torch.randn(Cc, f.dim, generator=g)).to(cuda_device)
    h = torch.full((Cc,), 0.3, device=cuda_device)
    dl = torch.full((Cc,), 0.2, device=cuda_device)
    kw = dict(target=user, cfg=tw.WalnutsConfig(m=5), num_iter=10 ** 6,
              stop_mode="min_per_chain", rounds=ROUNDS,
              micro_unroll=unroll, device=cuda_device)
    st = mk.run_walnuts_fused(7, q0, h, dl, **kw)[-1]   # builds, warms
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            st = mk.run_walnuts_fused(7, q0, h, dl, mk_state=st, **kw)[-1]
        torch.cuda.synchronize()
    spans = trace.spans()
    names = Counter(s.name for s in spans)
    assert names["call"] == names["capture"] == calls
    launches = [s for s in spans if s.name in ("launch", "ahead")]
    assert len(launches) == calls * PERIODS
    assert names["launch"] == names["period"] == calls
    for s in spans:
        if s.name == "capture":
            assert spans[s.parent].name == "launch"
    cuda = torch.autograd.DeviceType.CUDA
    segs = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and "round_kernel" in e.name())
    per = mk.FLUSH_EVERY * unroll + 1
    assert len(segs) == per * len(launches)
    for k, s in enumerate(launches):
        assert segs[k * per] >= s.t0_ns
