"""The CUDA round kernel against its plain twin, on the card.

These cases need a CUDA device and ``nvcc``; without them they skip.
The file imports neither JAX nor the JAX package, so it runs on a GPU
host without them (``--noconftest`` skips the suite's JAX setup):

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_round_kernel_gpu.py
"""

import ctypes

import pytest
import torch

import walnuts_tpu_torch as tw
from walnuts_tpu_torch.sampler import megakernel as mk
from walnuts_tpu_torch.sampler import round_kernel as rk
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT


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
    # the main path's width and depth: four trial values per lane
    "funnel101_m8_f64": dict(
        target=lambda: tw.targets.funnel(101), dtype=torch.float64,
        warmup=None, stop_mode="min_per_chain", micro_unroll=4, m=8),
    # three trial values per lane.  No warmup: with per-chain warmup at
    # this width even the JAX engine and the twin drift past rtol 1e-9
    # (test_kernel_per_chain_warmup_at_d80_within_the_engines_drift)
    "gauss80_f64_per_chain": dict(
        target=lambda: tw.targets.std_gauss(80), dtype=torch.float64,
        warmup=None, stop_mode="per_chain", micro_unroll=1),
    # D > 128: the instantiation that keeps the trial vectors in the bank
    "gauss200_f64_wide": dict(
        target=lambda: tw.targets.std_gauss(200), dtype=torch.float64,
        warmup=None, stop_mode="min_per_chain", micro_unroll=2),
}


def _kernel_and_twin(device, cfg, seed=77):
    """Banks after 160 rounds of 48 chains through the kernel and
    through the plain twin, from the same state."""
    target = cfg["target"]()
    dt = cfg["dtype"]
    g = torch.Generator().manual_seed(5)
    q0 = (0.3 * torch.randn(48, target.dim, generator=g,
                            dtype=torch.float64)).to(device, dt)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=cfg.get("m", 5)),
              num_iter=12, stop_mode=cfg["stop_mode"], warmup=cfg["warmup"],
              rounds=160, diag_rows=4, micro_unroll=cfg["micro_unroll"])
    h = torch.full((48,), 0.4, dtype=dt, device=device)
    dl = torch.full((48,), 0.2, dtype=dt, device=device)
    launches = rk.launches
    a = rk.pack(mk.run_walnuts_fused(seed, q0, h, dl, **kw)[-1])
    assert rk.launches > launches
    b = rk.pack(mk.run_walnuts_fused_plain(seed, q0, h, dl, **kw)[-1])
    torch.cuda.synchronize()
    assert int(a.si[rk.I_FIELDS.index("it")].sum()) > 0
    return a, b


def _assert_banks_close(a, b, rtol, atol):
    torch.testing.assert_close(a.si, b.si, rtol=0, atol=0)
    for name in ("sf", "vx", "slab_q", "slab_v", "samples", "diags"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_kernel_matches_plain_twin_on_gpu(cuda_device, case):
    """float64 exact contract on the card: integer banks equal, floats
    to rtol 1e-9, atol 1e-12, after 160 rounds."""
    a, b = _kernel_and_twin(cuda_device, GPU_CASES[case])
    _assert_banks_close(a, b, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_kernel_per_chain_warmup_at_d80_within_the_engines_drift(cuda_device):
    """std_gauss(80) with per-chain warmup, under the adaptive contract
    (``walnuts_tpu_torch.utils.parity.ADAPTIVE``): there the JAX engine
    and the plain twin themselves drift past rtol 1e-9 / atol 1e-12 in
    float64 and stay within rtol 1e-8 / atol 1e-9
    (``test_torch_megakernel.py`` pins it on these inputs, with the hash
    seed the JAX engine derives from PRNGKey(77)).  The kernel is held to
    that bound against the twin, integer banks equal."""
    a, b = _kernel_and_twin(cuda_device, dict(
        target=lambda: tw.targets.std_gauss(80), dtype=torch.float64,
        warmup=tw.WarmupConfig(warmup_iter=8), stop_mode="per_chain",
        micro_unroll=1), seed=506380528)
    _assert_banks_close(a, b, **ADAPTIVE)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["adapt_leapfrog_d",
                                        "adapt_leapfrog_r2p",
                                        "fixed_leapfrog"])
def test_stock_watson_kernel_matches_plain_twin_on_gpu(cuda_device,
                                                       integrator):
    """Stock-Watson (the proper model, D = 756, its ``[sigma, z, x,
    tau]`` summary stored) under each of the example's protocols:
    float64, 8 chains, 64 rounds of up to four micro steps, kernel
    against its twin under the exact contract."""
    target = tw.targets.stock_watson(proper=True)
    C = 8
    g = torch.Generator().manual_seed(3)
    q0 = (0.1 * torch.randn(C, target.dim, generator=g,
                            dtype=torch.float64)).to(cuda_device)
    igr = {} if integrator == "fixed_leapfrog" else dict(min_c=2)
    kw = dict(target=target, num_iter=12, stop_mode="min_per_chain",
              rounds=64, diag_rows=4, micro_unroll=4,
              cfg=tw.WalnutsConfig(m=4, integrator=integrator,
                                   igr=tw.IntegratorConfig(**igr)))
    h = torch.full((C,), 0.02, dtype=torch.float64, device=cuda_device)
    dl = torch.full((C,), 0.3, dtype=torch.float64, device=cuda_device)
    launches = rk.launches
    a = rk.pack(mk.run_walnuts_fused(9, q0, h, dl, **kw)[-1])
    assert rk.launches == launches + 4
    b = rk.pack(mk.run_walnuts_fused_plain(9, q0, h, dl, **kw)[-1])
    torch.cuda.synchronize()
    assert int(a.si[rk.I_FIELDS.index("grad_ct")].sum()) > 0
    _assert_banks_close(a, b, rtol=1e-9, atol=1e-12)
    assert rk.kernel_attributes(torch.float64, "stock_watson", 756)[
        "dpl"] == 0


@pytest.mark.cuda
def test_float32_momentum_cosine_is_cosf_on_every_draw(cuda_device):
    """The float32 kernel's cos(2 pi u) (cosf's fast path without its
    large-argument branch) equals cosf bit for bit on all 2^24 draws."""
    from walnuts_tpu_torch import _build

    fn = _build.load().walnuts_cos2pi_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    assert fn(bad.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    assert int(bad) == 0


@pytest.mark.cuda
def test_main_path_instantiation_keeps_registers_for_24_warps(cuda_device):
    """The float32 funnel instantiation at D=101 fits 80 registers with
    no local memory, so 24 warps (chains) are resident on each SM."""
    a = rk.kernel_attributes(torch.float32, "funnel", 101)
    assert a["dpl"] == 4 and a["regs"] <= 80 and a["local_bytes"] == 0
    assert a["warps_per_sm"] >= 24
    assert rk.kernel_attributes(torch.float64, "std_gauss", 200)["dpl"] == 0


def _lambda_summary(q):
    """``bench.py``'s (omega, sum x^2) as a new function (the kernel
    matches ``omega_sumsq`` by identity only)."""
    return torch.stack([q[..., 0], torch.sum(q[..., 1:] ** 2, dim=-1)], -1)


def _run_pair(run, target, cuda_device):
    """``run`` on the card and the plain engine on the CPU, from the same
    24 chains."""
    g = torch.Generator().manual_seed(9)
    q0 = 0.3 * torch.randn(24, target.dim, generator=g, dtype=torch.float64)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=4), num_iter=10,
              stop_mode="per_chain", rounds=96, diag_rows=4,
              micro_unroll=2)
    h, dl = torch.full((24,), 0.3, dtype=torch.float64), \
        torch.full((24,), 0.2, dtype=torch.float64)
    out = run(31, q0, h, dl, device=cuda_device, **kw)
    torch.cuda.synchronize()
    ref = mk.run_walnuts_fused(31, q0, h, dl, device="cpu", **kw)
    torch.testing.assert_close(out[3].cpu(), ref[3], rtol=0, atol=0)
    assert out[4] == ref[4] and int(ref[3].sum()) > 0
    for a, b in zip(out[:3], ref[:3]):
        torch.testing.assert_close(a.cpu(), b, equal_nan=True, **EXACT)


@pytest.mark.cuda
def test_summary_the_kernel_does_not_store_runs_in_the_kernel(cuda_device):
    """A summary other than the kernel's three: the kernel stages the
    positions and torch maps the summary; equal to the CPU run."""
    before = rk.launches
    _run_pair(mk.run_walnuts_fused,
              tw.targets.funnel(7, generated=_lambda_summary), cuda_device)
    assert rk.launches > before


@pytest.mark.cuda
def test_target_without_a_fused_gradient_runs_in_the_kernel_and_plain_by_name(
        cuda_device):
    """``run_walnuts_fused`` runs a target the kernel does not fuse
    through its external-gradient segments on the card, and
    ``run_walnuts_fused_plain`` runs it in the plain twin there; both
    equal the CPU run."""
    fused, segs = rk.launches, rk.segment_launches
    _run_pair(mk.run_walnuts_fused, tw.targets.smile(), cuda_device)
    assert rk.launches == fused and rk.segment_launches > segs
    segs = rk.segment_launches
    _run_pair(mk.run_walnuts_fused_plain, tw.targets.smile(), cuda_device)
    assert rk.launches == fused and rk.segment_launches == segs
