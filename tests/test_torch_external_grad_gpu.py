"""The CUDA round kernel's external-gradient instantiation against its
plain twin, on the card.

A target without a fused gradient runs a flush period as ``16 *
micro_unroll + 1`` segment launches with one call of the target's torch
``logp_grad`` between each two.  Each case runs the same capped
invocation through ``run_walnuts_fused`` (the segments) and through
``run_walnuts_fused_plain`` (the plain round body) on the card in
float64 and holds them to the exact contract: integer banks equal,
floats within ``EXACT``.  The cases need a CUDA device and ``nvcc``;
without them they skip.  The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_external_grad_gpu.py
"""

import json
import math

import numpy as np
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


def _user_logp(q):
    """A user's density over one ``[3]`` position, with no gradient."""
    return (-0.5 * (q[0] ** 2 + (q[1] - 0.5 * q[0] ** 2) ** 2)
            - 0.125 * q[2] ** 2)


def half_space(dim=4):
    """A standard normal cut to ``q[0] > -0.5``: ``lp = -inf`` past the
    cut, so trials that cross it end with a non-finite energy."""

    def logp_grad(q):
        lp = -0.5 * torch.sum(q * q, dim=-1)
        return torch.where(q[..., 0] > -0.5, lp, -math.inf), -q

    return tw.Target(lambda q: logp_grad(q[None])[0][0], dim,
                     name="half_space", logp_grad=logp_grad)


POOLED = tw.WarmupConfig(warmup_iter=8, pooled=True)
PER_CHAIN = tw.WarmupConfig(warmup_iter=8)

# the targets without a fused gradient, each under its own stop mode,
# micro_unroll and warmup, so that the set covers all three modes,
# micro_unroll 1 to 4 and both kinds of warmup
TARGET_CASES = {
    "smile": (tw.targets.smile, "per_chain", 1, None),
    "corr_gauss": (tw.targets.corr_gauss, "total", 4, None),
    "rosenbrock": (tw.targets.rosenbrock, "min_per_chain", 4, None),
    "mod_funnel": (tw.targets.mod_funnel, "per_chain", 2, PER_CHAIN),
    "funnel_rescaled": (lambda: tw.targets.funnel_rescaled(5),
                        "min_per_chain", 1, POOLED),
    "ill_conditioned_gauss": (lambda: tw.targets.ill_conditioned_gauss(5),
                              "total", 3, None),
    "user_lambda": (lambda: tw.Target(_user_logp, 3, name="user"),
                    "per_chain", 4, POOLED),
    "half_space": (half_space, "min_per_chain", 2, None),
}


def _q0(C, dim, device, seed=5, scale=0.3):
    g = np.random.default_rng(seed)
    return torch.from_numpy(scale * g.normal(size=(C, dim))).to(device)


def _pair(device, target, *, stop_mode, micro_unroll, warmup, C=48, m=5,
          rounds=160, h0=0.3, delta=0.2, q0=None, cfg=None, seed=77):
    """The capped invocation through the segments and through the plain
    twin on the card; returns both outputs, after checking that the
    segments (and not the fused kernel) ran: ``16 * micro_unroll + 1``
    launches per period."""
    q0 = _q0(C, target.dim, device) if q0 is None else q0
    kw = dict(target=target, cfg=cfg or tw.WalnutsConfig(m=m), num_iter=12,
              stop_mode=stop_mode, warmup=warmup, rounds=rounds,
              diag_rows=4, micro_unroll=micro_unroll)
    h = torch.full((C,), h0, dtype=torch.float64, device=device)
    dl = torch.full((C,), delta, dtype=torch.float64, device=device)
    fused, segs = rk.launches, rk.segment_launches
    ext = mk.run_walnuts_fused(seed, q0, h, dl, **kw)
    torch.cuda.synchronize()
    periods = ext[-1].n // mk.FLUSH_EVERY
    assert periods > 0 and rk.launches == fused
    assert rk.segment_launches - segs == periods * (
        mk.FLUSH_EVERY * micro_unroll + 1)
    plain = mk.run_walnuts_fused_plain(seed, q0, h, dl, **kw)
    torch.cuda.synchronize()
    assert rk.segment_launches - segs == periods * (
        mk.FLUSH_EVERY * micro_unroll + 1)
    return ext, plain


def _assert_exact(ext, plain, deferred=False, contract=EXACT):
    """Integer banks equal, floats within ``EXACT``.  Under a summary the
    kernel does not store (``deferred``), the returned state's two
    pending slots hold the summary mapped over the staged positions,
    which for a slot no draw ever used is the summary of zeros, not the
    plain run's zeros: the slots are empty between periods, so their
    payload rows are left out there."""
    a, b = rk.pack(ext[-1]), rk.pack(plain[-1])
    torch.testing.assert_close(a.si, b.si, rtol=0, atol=0)
    if deferred:
        lay = rk.layout(a.samples.shape[2])
        keep = torch.ones(a.sf.shape[0], dtype=torch.bool)
        keep[lay.pgen0:lay.pdiag0] = False
        a, b = a._replace(sf=a.sf[keep]), b._replace(sf=b.sf[keep])
    for name in ("sf", "vx", "slab_q", "slab_v", "samples", "diags"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   equal_nan=True, **contract)
    assert ext[4] == plain[4] > 0
    assert int(ext[3].sum()) > 0
    for x, y in zip(ext[:3], plain[:3]):
        torch.testing.assert_close(x, y, equal_nan=True, **contract)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TARGET_CASES))
def test_external_route_matches_plain_twin_on_gpu(cuda_device, case):
    """Each target without a fused gradient, float64, 160 rounds: the
    kernel's segments against the plain twin under the exact
    contract."""
    make, stop_mode, unroll, warmup = TARGET_CASES[case]
    ext, plain = _pair(cuda_device, make(), stop_mode=stop_mode,
                       micro_unroll=unroll, warmup=warmup)
    _assert_exact(ext, plain)


@pytest.mark.cuda
def test_pooled_warmup_on_a_stiff_target_within_the_adaptive_contract(
        cuda_device):
    """Rosenbrock (curvature 1 / 0.19^2) under pooled warmup, held to the
    contract for runs that adapt H and delta
    (``walnuts_tpu_torch.utils.parity.ADAPTIVE``), integer banks equal.
    The segments contract each multiply-add of the kick and the drift,
    the twin rounds the product first; the target's gradient is a
    difference of near-equal terms scaled by 28, and the adapted H
    carries every chain's last bits to all chains.  On these inputs the
    worst float sits 1.04 times the exact bound from the twin (a
    gradient entry of 4.6e-4 off by 1.5e-12; an H100, 160 rounds), the
    same target with fixed tuning 0.003 times
    (``test_external_route_matches_plain_twin_on_gpu[rosenbrock]``)."""
    ext, plain = _pair(cuda_device, tw.targets.rosenbrock(),
                       stop_mode="min_per_chain", micro_unroll=4,
                       warmup=POOLED)
    _assert_exact(ext, plain, contract=ADAPTIVE)


@pytest.mark.cuda
@pytest.mark.parametrize("stop_mode", ["per_chain", "total",
                                       "min_per_chain"])
@pytest.mark.parametrize("micro_unroll", [1, 4])
def test_stop_modes_and_micro_unroll_on_gpu(cuda_device, stop_mode,
                                            micro_unroll):
    """``smile`` under every stop mode at micro_unroll 1 and 4."""
    ext, plain = _pair(cuda_device, tw.targets.smile(), stop_mode=stop_mode,
                       micro_unroll=micro_unroll, warmup=None, C=32,
                       rounds=96)
    _assert_exact(ext, plain)


@pytest.mark.cuda
def test_resume_across_periods_and_grad_mode_on_gpu(cuda_device):
    """A ``rounds=``/``mk_state`` resume through the segments: two calls
    of 48 rounds (three periods each) equal one call of 96 bit for bit,
    and the twin under the exact contract; the autograd target runs
    under the caller's ``torch.no_grad()``."""
    target = tw.targets.mod_funnel()
    C = 32
    q0 = _q0(C, 2, cuda_device, seed=8)
    h = torch.full((C,), 0.3, dtype=torch.float64, device=cuda_device)
    dl = torch.full((C,), 0.2, dtype=torch.float64, device=cuda_device)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=5), num_iter=40,
              stop_mode="per_chain", warmup=POOLED, diag_rows=4,
              micro_unroll=3)
    with torch.no_grad():
        one = mk.run_walnuts_fused(3, q0, h, dl, rounds=96, **kw)
        half = mk.run_walnuts_fused(3, q0, h, dl, rounds=48, **kw)
        assert half[-1].n == 48
        two = mk.run_walnuts_fused(3, q0, h, dl, rounds=48,
                                   mk_state=half[-1], **kw)
    torch.cuda.synchronize()
    assert two[-1].n == one[-1].n == 96
    for a, b in zip(rk.pack(one[-1]), rk.pack(two[-1])):
        assert torch.equal(a, b)
    plain = mk.run_walnuts_fused_plain(3, q0, h, dl, rounds=96, **kw)
    _assert_exact(one, plain)


@pytest.mark.cuda
def test_stock_watson_past_the_fused_length_on_gpu(cuda_device, tmp_path):
    """Stock-Watson at T = 300 (past ``SW_TMAX``; D = 900) on a
    numpy-seeded synthetic series: the segments with the target's torch
    gradient, its summary mapped in torch, against the twin."""
    T = 300
    rng = np.random.default_rng(300)
    y = np.cumsum(0.3 * rng.normal(size=T)) + rng.normal(size=T)
    path = tmp_path / "sw300.json"
    path.write_text(json.dumps({"T": T, "y": y.tolist()}))
    target = tw.targets.stock_watson(path, proper=True)
    assert target.dim == 900
    assert rk._target_id(target, 900) == rk.EXTERNAL
    C = 8
    q0 = _q0(C, 900, cuda_device, seed=9, scale=0.1)
    cfg = tw.WalnutsConfig(m=4, integrator="adapt_leapfrog_d",
                           igr=tw.IntegratorConfig(min_c=2))
    ext, plain = _pair(cuda_device, target, stop_mode="min_per_chain",
                       micro_unroll=4, warmup=None, C=C, rounds=160,
                       h0=0.02, delta=0.3, q0=q0, cfg=cfg, seed=9)
    _assert_exact(ext, plain, deferred=True)
    assert ext[0].shape[-1] == 900  # (sigma, z, x, tau), mapped in torch


@pytest.mark.cuda
def test_external_route_on_the_card_matches_the_cpu(cuda_device):
    """One autograd target through the segments on the card against
    the plain engine on the CPU."""
    target = tw.targets.smile()
    q0 = _q0(24, 2, "cpu", seed=9)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=4), num_iter=10,
              stop_mode="per_chain", rounds=96, diag_rows=4,
              micro_unroll=2)
    h = torch.full((24,), 0.3, dtype=torch.float64)
    dl = torch.full((24,), 0.2, dtype=torch.float64)
    segs = rk.segment_launches
    out = mk.run_walnuts_fused(31, q0, h, dl, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert rk.segment_launches - segs == out[-1].n // mk.FLUSH_EVERY * 33
    ref = mk.run_walnuts_fused(31, q0, h, dl, device="cpu", **kw)
    torch.testing.assert_close(out[3].cpu(), ref[3], rtol=0, atol=0)
    assert out[4] == ref[4] and int(ref[3].sum()) > 0
    for a, b in zip(out[:3], ref[:3]):
        torch.testing.assert_close(a.cpu(), b, equal_nan=True, **EXACT)


@pytest.mark.cuda
def test_bad_gradient_raises_before_the_next_segment(cuda_device):
    """A ``logp_grad`` that returns the wrong dtype raises; nothing is
    cast and nothing runs on the plain twin."""
    base = tw.targets.smile()
    bad = tw.Target(base._logp, 2, name="bad",
                    logp_grad=lambda q: tuple(x.float()
                                              for x in base.logp_grad(q)))
    segs = rk.segment_launches
    with pytest.raises(TypeError, match="bad.logp_grad"):
        mk.run_walnuts_fused(1, _q0(8, 2, cuda_device), 0.3, 0.2, target=bad,
                             cfg=tw.WalnutsConfig(m=4), num_iter=2,
                             device=cuda_device)
    assert rk.segment_launches - segs == 1
