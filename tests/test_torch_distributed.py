"""Two processes through ``walnuts_tpu_torch.parallel.distributed_init``
(the port of ``tests/test_distributed.py``): a chain-split
``run_walnuts`` over two gloo ranks on the CPU, a cross-rank sum (the
primitive of the pooled warmup consensus), and the gathered draws
against the one-process run.  The ranks import only the port
(``tests/torch_rank_jobs.py``)."""

import numpy as np
import pytest

import torch_rank_jobs
import walnuts_tpu_torch as tw
from walnuts_tpu_torch.parallel import run_ranks

C, D = 8, 6


def test_two_process_distributed_chain_split():
    outs = run_ranks(torch_rank_jobs.distributed_smoke, 2, (C, D),
                     timeout=240.0, device="cpu")
    locals_ = [0.1 * np.arange(C // 2 * D, dtype=np.float32).reshape(
        C // 2, D) + pid for pid in (0, 1)]
    expect = float(sum(np.sum(x) for x in locals_))
    s, _, _ = tw.run_walnuts(
        0, np.concatenate(locals_), target=tw.targets.std_gauss(D),
        cfg=tw.WalnutsConfig(m=3),
        warmup=tw.WarmupConfig(warmup_iter=0, adapt_h=False,
                               adapt_delta=False),
        num_iter=3, h0=0.5, delta0=0.2, device="cpu")
    for pid, out in enumerate(outs):
        assert out["pid"] == pid
        assert out["local_shape"] == (4, C // 2, D)
        assert out["local_sum"] == float(np.sum(locals_[pid]))
        np.testing.assert_allclose(out["total"], expect, rtol=1e-5)
        assert out["samples"].shape == (4, C, D)
        # the one-process run's rows, to a few float32 ulps: torch's CPU
        # vector loops send a tail shorter than two vector widths through
        # the scalar op, so a batch of 4 chains and one of 8 may round
        # apart in the last bit
        np.testing.assert_allclose(out["samples"], s.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_a_failed_rank_fails_the_group_with_its_error():
    with pytest.raises(Exception, match="rank one failed on purpose"):
        run_ranks(torch_rank_jobs.fail_on_rank_one, 2, timeout=120.0,
                  device="cpu")
