"""The fused engine's launch-ahead: one read of the stop test queues every
flush period that the test cannot yet end (``megakernel.live_periods``).

On the CPU, through the plain twin at funnel(7), C = 16, m = 4, float64,
in each stop mode under fixed tuning and pooled warmup: a chain below
``num_iter`` gains at most two draws a period (the bound the launch-ahead
rests on); one call in which the stop fires mid-call equals, bit for
bit, calls of one period each resumed through ``mk_state`` (each reads
the stop test before its one period): its
outputs, its state and its launches, also under a rounds cap that is not
a multiple of 16; and the call reads the stop test exactly as often as
the bound says.  Two gloo ranks make the same launches and reads.  One
case, marked ``cuda``, holds a summary the kernel does not store to the
same on the card and finds no blocking read between two launches of one
turn.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_launch_ahead.py
"""

import numpy as np
import pytest
import torch

import walnuts_tpu_torch as tw
from walnuts_tpu_torch import parallel
from walnuts_tpu_torch.sampler import megakernel as mk

import torch_rank_jobs
from torch_rank_jobs import Counted, flat, period_by_period

torch.set_num_threads(2)

C, D, M, SEED, NUM_ITER = 16, 7, 4, 2024, 8
Q0 = 0.3 * np.random.default_rng(1).normal(size=(C, D))
CAP = 13 * mk.FLUSH_EVERY - 8   # 13 periods, the last of them cut short
CASES = [(mode, pooled) for mode in mk.STOP_MODES
         for pooled in (False, True)]
IDS = [f"{m}-{'pooled' if p else 'fixed'}" for m, p in CASES]


def _call(mode, pooled, target=None, device="cpu", q0=Q0,
          num_iter=NUM_ITER):
    """``(rounds, mk_state) -> outputs`` of one case's run."""
    n = q0.shape[0]
    h = torch.full((n,), 0.4, dtype=torch.float64)
    dl = torch.full((n,), 0.15, dtype=torch.float64)
    warmup = tw.WarmupConfig(warmup_iter=8, pooled=True) if pooled else None

    def call(rounds, st):
        return tw.run_walnuts_fused(
            SEED, torch.as_tensor(q0), h, dl,
            target=target or tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=M),
            warmup=warmup, num_iter=num_iter, stop_mode=mode, rounds=rounds,
            mk_state=st, device=device)

    return call


_RUNS = {}


def _period_by_period(mode, pooled):
    """A case run period by period (shared by the tests of this file)."""
    if (mode, pooled) not in _RUNS:
        out, its, reads = period_by_period(_call(mode, pooled))
        _RUNS[mode, pooled] = out, np.stack([x.numpy() for x in its]), reads
    return _RUNS[mode, pooled]


def _reads_by_the_bound(its, mode, p0=0, cap=None, chains=C):
    """The turns of a call from period ``p0`` under a cap of ``cap``
    periods, by the bound on the draw counts ``its`` (``its[p]`` before
    period ``p``): ``(stop-test reads, periods run)``."""
    reads, p = 0, p0
    while cap is None or p - p0 < cap:
        reads += 1
        it = its[p].astype(np.int64)
        if mode == "total":
            short, per = chains * NUM_ITER - it.sum(), 2 * chains
        else:
            short, per = NUM_ITER - it.min(), 2
        k = max(0, -(-short // per))
        if cap is not None:
            k = min(k, cap - (p - p0))
        if not k:
            break
        p += k
    return reads, p - p0


def _assert_same(a, b):
    a, b = flat(a), flat(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("mode, pooled", CASES, ids=IDS)
def test_a_chain_below_num_iter_gains_at_most_two_draws_a_period(mode,
                                                                 pooled):
    out, its, reads = _period_by_period(mode, pooled)
    before, after = its[:-1], its[1:]
    below = before < NUM_ITER
    # draws staged while below num_iter each fill one of two slots
    gained = (np.minimum(after, NUM_ITER) - before)[below]
    assert gained.max() == 2 and gained.min() >= 0
    if mode == "min_per_chain":
        # chains past quota keep transitioning, unbounded, and no longer
        # decide the stop
        assert after[-1].max() > NUM_ITER + 2
        assert ((before < NUM_ITER) & (after >= NUM_ITER)).any()
    else:
        assert (after - before).max() == 2
    # the run went to its stop, one read per one-period call
    assert len(its) > 12 and reads == [1] * len(reads)
    if mode == "total":
        assert its[-1].sum() >= C * NUM_ITER > its[-2].sum()
    else:
        assert its[-1].min() >= NUM_ITER > its[-2].min()


@pytest.mark.parametrize("mode, pooled", CASES, ids=IDS)
def test_one_call_equals_one_period_at_a_time(mode, pooled):
    ref, its, _ = _period_by_period(mode, pooled)
    periods = len(its) - 1
    mk.stop_readbacks = 0
    with Counted() as c:
        one = _call(mode, pooled)(10 ** 6, None)
    _assert_same(one, ref)
    assert one[-1].n == periods * mk.FLUSH_EVERY and c.periods == periods
    assert one[4] == int(ref[-1].grad_ct.sum()) > 0
    reads, ran = _reads_by_the_bound(its, mode)
    assert ran == periods and mk.stop_readbacks == reads
    # the stop fired mid-call, after several turns
    assert 2 <= reads < periods


@pytest.mark.parametrize("mode, pooled", [("per_chain", False),
                                          ("min_per_chain", True)],
                         ids=["per_chain-fixed", "min_per_chain-pooled"])
def test_a_rounds_cap_not_a_multiple_of_16_then_resumed(mode, pooled):
    ref, its, _ = _period_by_period(mode, pooled)
    cut = -(-CAP // mk.FLUSH_EVERY)
    call = _call(mode, pooled)
    mk.stop_readbacks = 0
    with Counted() as c:
        first = call(CAP, None)
    assert c.periods == cut and first[-1].n == cut * mk.FLUSH_EVERY
    assert (mk.stop_readbacks, cut) == _reads_by_the_bound(its, mode, cap=cut)
    assert torch.equal(first[-1].it, torch.from_numpy(its[cut]))
    mk.stop_readbacks = 0
    with Counted() as c:
        rest = call(None, first[-1])
    assert c.periods == len(its) - 1 - cut
    assert mk.stop_readbacks == _reads_by_the_bound(its, mode, p0=cut)[0]
    # without a cap the call returns no state: its outputs are the rest
    _assert_same(rest, ref[:-1])


def test_a_call_the_cap_ends_reads_the_stop_test_once():
    """A call the rounds cap ends reads the stop test once where one
    turn holds every period, and never after its last period."""
    call = _call("per_chain", False, num_iter=10 ** 4)
    mk.stop_readbacks = 0
    with Counted() as c:
        st = call(CAP, None)[-1]
    assert (mk.stop_readbacks, c.periods) == (1, 13)
    mk.stop_readbacks = 0
    with Counted() as c:
        call(0, st)
    assert (mk.stop_readbacks, c.periods) == (0, 0)


def test_live_periods_from_the_counts():
    it = torch.tensor([5, 9, 12, 3], dtype=torch.int32)
    assert mk.live_periods(it, "per_chain", 12, 4) == 5
    assert mk.live_periods(it, "min_per_chain", 4, 4) == 1
    assert mk.live_periods(it, "min_per_chain", 3, 4) == 0
    # 48 - 29 short of the total, at most 8 draws a period
    assert mk.live_periods(it, "total", 12, 4) == 3
    assert mk.live_periods(it, "total", 7, 4) == 0


def test_two_ranks_make_the_same_launches_and_reads():
    cases = [("per_chain", NUM_ITER), ("total", NUM_ITER)]
    q0 = 0.3 * np.random.default_rng(5).normal(size=(16, D))
    ranks = parallel.run_ranks(torch_rank_jobs.launch_ahead, 2,
                               (q0, SEED, cases), timeout=240.0,
                               device="cpu")
    for k, (mode, _) in enumerate(cases):
        r0, r1 = (r[k] for r in ranks)
        assert r0["same"] and r1["same"]
        for key in ("rounds", "periods", "reads"):
            assert r0[key] == r1[key], key
        for a, b in zip(r0["its"], r1["its"]):
            np.testing.assert_array_equal(a, b)
        its = np.stack(r0["its"])
        reads, ran = _reads_by_the_bound(its, mode, chains=16)
        assert (r0["reads"], r0["periods"]) == (reads, ran)
        assert r0["rounds"] == ran * mk.FLUSH_EVERY and 2 <= reads < ran


WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "aten::_local_scalar_dense")


@pytest.mark.cuda
def test_deferred_summary_on_the_card_and_no_wait_inside_a_turn():
    """On the card, funnel(11) with a summary the kernel does not store
    (mapped in torch after each period), in ``min_per_chain``: one call
    equals one period at a time bit for bit, reads the card once per
    turn and once for its gradient count, and from the end of a turn's
    first launch to the start of its last the host never waits for the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from torch.profiler import ProfilerActivity, profile

    from walnuts_tpu_torch.sampler import round_kernel as rk
    from walnuts_tpu_torch.utils import trace

    target = tw.targets.funnel(
        11, generated=lambda q: torch.stack([q[..., 0], q[..., 1] ** 2], -1))
    n = 256
    q0 = 0.3 * np.random.default_rng(2).normal(size=(n, 11))
    call = _call("min_per_chain", False, target=target, device="cuda", q0=q0)
    assert not rk.check_card(rk.RoundSpec(
        target, tw.WalnutsConfig(m=M), None, "min_per_chain", NUM_ITER, 1,
        SEED))
    ref, its, _ = period_by_period(call)
    periods = len(its) - 1
    torch.cuda.synchronize()
    trace.reset()
    mk.stop_readbacks = 0
    before = rk.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one = call(10 ** 6, None)
        torch.cuda.synchronize()
    spans = trace.spans()
    trace.reset()
    assert rk.launches - before == periods
    # the pending slots' positions are scratch, empty between periods,
    # that each call with a deferred summary zeroes (defer_summary): the
    # period-by-period run's last call, which launches nothing, returns
    # them so
    _assert_same(one[:-1], ref[:-1])
    _assert_same(one[-1]._replace(pgen0=0, pgen1=0),
                 ref[-1]._replace(pgen0=0, pgen1=0))
    its = np.stack([x.cpu().numpy() for x in its])
    reads, _ = _reads_by_the_bound(its, "min_per_chain", chains=n)
    assert mk.stop_readbacks == reads and 2 <= reads < periods
    events = [(e.start_ns(), e.name())
              for e in prof.profiler.kineto_results.events()]
    waits = [t for t, name in events if name in WAITS]
    reads_ = sum(1 for _, name in events
                 if name == "aten::_local_scalar_dense")
    assert reads_ == reads + 1, reads_
    turns = {}
    for s in spans:
        if s.name in ("launch", "ahead"):
            turns.setdefault(s.parent, []).append(s)
    assert sum(len(t) for t in turns.values()) == periods
    for t in turns.values():
        inside = [w for w in waits if t[0].t1_ns < w < t[-1].t0_ns]
        assert not inside, (len(t), len(inside))
