"""The CUDA round kernel against its plain twin, on the card.

These cases need a CUDA device and ``nvcc``; without them they skip.
The file imports neither JAX nor the JAX package, so it runs on a GPU
host without them (``--noconftest`` skips the suite's JAX setup):

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_round_kernel_gpu.py
"""

import pytest
import torch

import walnuts_tpu_torch as tw
from walnuts_tpu_torch.sampler import megakernel as mk
from walnuts_tpu_torch.sampler import round_kernel as rk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


GPU_CASES = {
    "funnel_f64_fixed": dict(
        target=lambda: tw.targets.funnel(7), dtype=torch.float64,
        warmup=None, stop_mode="min_per_chain", micro_unroll=1),
    "gauss_f64_per_chain_warmup": dict(
        target=lambda: tw.targets.std_gauss(9), dtype=torch.float64,
        warmup=tw.WarmupConfig(warmup_iter=8), stop_mode="per_chain",
        micro_unroll=2),
    "funnel_f64_total_summary": dict(
        target=lambda: tw.targets.funnel(
            33, generated=tw.targets.omega_sumsq), dtype=torch.float64,
        warmup=None, stop_mode="total", micro_unroll=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_kernel_matches_plain_twin_on_gpu(cuda_device, case):
    """float64 exact contract on the card: integer banks equal, floats
    to rtol 1e-9, atol 1e-12, after 160 rounds."""
    cfg = GPU_CASES[case]
    target = cfg["target"]()
    dt = cfg["dtype"]
    g = torch.Generator().manual_seed(5)
    q0 = (0.3 * torch.randn(48, target.dim, generator=g,
                            dtype=torch.float64)).to(cuda_device, dt)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=5), num_iter=12,
              stop_mode=cfg["stop_mode"], warmup=cfg["warmup"], rounds=160,
              diag_rows=4, micro_unroll=cfg["micro_unroll"])
    h = torch.full((48,), 0.4, dtype=dt, device=cuda_device)
    dl = torch.full((48,), 0.2, dtype=dt, device=cuda_device)
    launches = rk.launches
    a = rk.pack(mk.run_walnuts_fused(77, q0, h, dl, **kw)[-1])
    assert rk.launches > launches
    b = rk.pack(mk.run_walnuts_fused_plain(77, q0, h, dl, **kw)[-1])
    torch.cuda.synchronize()
    torch.testing.assert_close(a.si, b.si, rtol=0, atol=0)
    for name in ("sf", "vx", "slab_q", "slab_v", "samples", "diags"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=1e-9, atol=1e-12, equal_nan=True)
    assert int(a.si[rk.I_FIELDS.index("it")].sum()) > 0
