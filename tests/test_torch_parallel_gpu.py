"""Chains split over ranks on the card (``walnuts_tpu_torch.parallel``).

These cases need a CUDA device and ``nvcc``; without them they skip.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_parallel_gpu.py
"""

import pytest
import torch

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
