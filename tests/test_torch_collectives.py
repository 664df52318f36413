"""The chains axis's collectives (``walnuts_tpu_torch.parallel.mesh``:
``reduce_int`` and ``gather_rows``) under a split: each is counted in
``mesh.chain_collectives`` and spanned as ``collective`` inside the span
of the step that makes it, the fused engine's stop test (``readback``)
or the pooled warmup's consensus (``consensus``); without a split none
is.  Two gloo ranks on the CPU, funnel(7), C = 16, m = 4, 64 rounds
(four flush periods).  The file imports neither JAX nor the JAX
package."""

import numpy as np
import pytest
import torch

import torch_rank_jobs
import walnuts_tpu_torch as tw
from walnuts_tpu_torch import parallel
from walnuts_tpu_torch.parallel import mesh as pm
from walnuts_tpu_torch.sampler import megakernel as mk

C, D, ROUNDS = 16, 7, 64
PERIODS = ROUNDS // mk.FLUSH_EVERY
Q0 = 0.3 * np.random.default_rng(3).normal(size=(C, D))
POOLED = dict(warmup_iter=20, pooled=True)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def two_ranks():
    return parallel.run_ranks(torch_rank_jobs.collectives, 2,
                              (Q0, 12345, ROUNDS, POOLED), timeout=300.0,
                              device="cpu")


@pytest.fixture(scope="module")
def one_rank():
    return parallel.run_ranks(torch_rank_jobs.collectives, 1,
                              (Q0, 12345, ROUNDS, POOLED), timeout=300.0,
                              device="cpu")[0]


@pytest.mark.parametrize("rank", [0, 1])
def test_a_capped_call_spans_one_collective_per_stop_test(two_ranks, rank):
    got = two_ranks[rank]["fixed"]
    # the rounds cap ends the call in one turn: one read of the stop test
    assert got["reads"] == 1 and got["periods"] == PERIODS
    assert got["parents"] == ["readback"] * got["reads"]
    assert got["inside"]


@pytest.mark.parametrize("rank", [0, 1])
def test_a_run_to_its_stop_spans_each_read(two_ranks, rank):
    got = two_ranks[rank]["to_stop"]
    assert got["reads"] >= 3
    assert got["parents"] == ["readback"] * got["reads"]
    assert got["counted"] == got["reads"]


@pytest.mark.parametrize("rank", [0, 1])
def test_pooled_warmup_spans_one_more_per_period(two_ranks, rank):
    got = two_ranks[rank]["pooled"]
    assert got["reads"] == 1 and got["periods"] == PERIODS
    assert got["parents"] == ["readback"] + ["consensus"] * PERIODS
    assert got["inside"]


@pytest.mark.parametrize("case", ["fixed", "pooled", "to_stop"])
def test_the_counter_counts_the_collectives(two_ranks, case):
    for got in two_ranks:
        want = got[case]["reads"] + (PERIODS if case == "pooled" else 0)
        assert got[case]["counted"] == len(got[case]["parents"]) == want


@pytest.mark.parametrize("case", ["fixed", "pooled", "to_stop"])
def test_one_rank_makes_no_collective(one_rank, case):
    got = one_rank[case]
    assert got["reads"] >= 1
    assert got["counted"] == 0 and got["parents"] == []


@pytest.mark.parametrize("warmup", [None, POOLED], ids=["fixed", "pooled"])
def test_no_mesh_makes_no_collective(warmup):
    from walnuts_tpu_torch.utils import trace

    trace.reset()
    trace.enable(True)
    pm.chain_collectives = 0
    try:
        tw.run_walnuts_fused(
            12345, torch.from_numpy(Q0), 0.4, 0.15,
            target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=4),
            num_iter=10 ** 6,
            warmup=None if warmup is None else tw.WarmupConfig(**warmup),
            rounds=ROUNDS, device="cpu")
        names = {s.name for s in trace.spans()}
    finally:
        trace.enable(None)
        trace.reset()
    assert "readback" in names and "collective" not in names
    assert pm.chain_collectives == 0


@pytest.mark.parametrize("op, want", [("sum", 3), ("min", -2), ("max", 5)])
@pytest.mark.parametrize("kind", ["int32", "int64", "int"])
def test_reduce_int_over_two_ranks(two_ranks, op, want, kind):
    for got in two_ranks:
        value = got["reduce"][(op, kind)]
        assert type(value) is int and value == want
        assert got["int64_kept"]


@pytest.mark.parametrize("kind", ["int32", "int64", "int"])
def test_reduce_int_on_one_rank_is_the_value(one_rank, kind):
    assert {op: one_rank["reduce"][(op, kind)]
            for op in ("sum", "min", "max")} == dict(sum=5, min=5, max=5)
