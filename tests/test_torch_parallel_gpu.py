"""Chains split over ranks on the card (``walnuts_tpu_torch.parallel``).

These cases need a CUDA device and ``nvcc``; without them they skip.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_parallel_gpu.py
"""

import numpy as np
import pytest
import torch

import torch_rank_jobs
import walnuts_tpu_torch as tw
from walnuts_tpu_torch import parallel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(cuda_device):
    """The dry run's default places its ranks on the card: a card per
    rank over NCCL where the host has enough, else all on one card over
    gloo."""
    n = 2
    dev, backend = parallel.rank_layout("cuda", n, 1)
    if torch.cuda.device_count() >= n:
        assert (str(dev), backend) == ("cuda:1", "nccl")
    else:
        assert dev.type == "cuda" and backend == "gloo"
    report = tw.entry.dryrun_multichip(n, timeout=300)
    assert report["ranks"] == n and report["rank"] == 0
    assert report["diag"] == (2 * n, 24) and report["counts"] == (2 * n,)
    assert report["draws"] == (4, 2 * n, 7) and report["grads"] > 0


@pytest.mark.cuda
def test_four_nccl_ranks_equal_one_process(cuda_device):
    """Four ranks of 1,024 chains, a card each over NCCL: two capped
    sampling calls, a call that the stop test ends, and four periods of
    pooled warmup on the main path's settings
    (``torch_rank_jobs.fused_rows``).  Each rank's positions, draws, draw
    and gradient counts and the consensus's (H, delta) equal bit for bit
    its rows of one process of 4,096 chains on card 0, after the same
    rounds; each capped call makes one collective (its stop test), the
    call run to its stop one a read of the test, and the warmup call one
    more a period (the consensus's all-gather).  ``reduce_int`` returns
    the sum, min and max over the ranks from a count on the card or a
    host int."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    n, C = 4, 4096
    z = np.random.default_rng(20).standard_normal((C, 101))
    q0 = np.concatenate([3.0 * z[:, :1], np.exp(1.5 * z[:, :1]) * z[:, 1:]],
                        axis=1).astype(np.float32)
    one = torch_rank_jobs.fused_rows(q0, 7771, device=torch.device("cuda:0"))
    ranks = parallel.run_ranks(torch_rank_jobs.nccl_rows, n, (q0, 7771),
                               timeout=600, device="cuda")
    # the stop test ended that call: its slowest chain at quota, the cap
    # far off, and more than one read on the way
    stop = one["to_stop"]
    assert int(stop["it"].min()) >= torch_rank_jobs.TO_STOP
    assert stop["n"] < 2 ** 20 and stop["reads"] >= 2
    for phase, calls, periods in (("first", 1, 0), ("second", 2, 0),
                                  ("to_stop", stop["reads"], 0),
                                  ("warmup", 1, 4)):
        whole = one[phase]
        assert whole["counted"] == 0
        for r, got in enumerate(ranks):
            got = got[phase]
            block = slice(r * C // n, (r + 1) * C // n)
            for f in ("qc", "it", "grad_ct", "h", "delta"):
                assert torch.equal(got[f], whole[f][block]), (phase, r, f)
            assert torch.equal(got["samples"], whole["samples"][:, block])
            assert got["n"] == whole["n"]
            assert got["reads"] == calls
            assert got["counted"] == calls + periods
        assert sum(g[phase]["total"] for g in ranks) == whole["total"]
    values = torch_rank_jobs.REDUCED
    want = dict(sum=sum(values), min=min(values), max=max(values))
    for got in ranks:
        assert got["int64_kept"]
        for (op, kind), value in got["reduce"].items():
            assert type(value) is int and value == want[op], (op, kind)
        assert len(got["reduce"]) == 9
