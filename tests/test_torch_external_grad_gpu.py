"""The CUDA round kernel's external-gradient instantiation against its
plain twin, on the card.

A target without a fused gradient runs a flush period as ``16 *
micro_unroll + 1`` segment launches with one call of the target's torch
``logp_grad`` between each two, captured once as a CUDA graph and
replayed.  Each case runs the same capped invocation through
``run_walnuts_fused`` (the segments) and through
``run_walnuts_fused_plain`` (the plain round body) on the card in
float64 and holds them to the exact contract: integer banks equal,
floats within ``EXACT``.  The graphed periods are held bit for bit to
the same segments run eagerly.  The cases need a CUDA device and
``nvcc``; without them they skip.  The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_external_grad_gpu.py
"""

import functools
import json
import math
import warnings

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
    cast and nothing runs on the plain twin.  It raises in the calls
    that warm the target up before the period's capture, so no segment
    was launched."""
    base = tw.targets.smile()
    bad = tw.Target(base._logp, 2, name="bad",
                    logp_grad=lambda q: tuple(x.float()
                                              for x in base.logp_grad(q)))
    segs = rk.segment_launches
    with pytest.raises(TypeError, match="bad.logp_grad"):
        mk.run_walnuts_fused(1, _q0(8, 2, cuda_device), 0.3, 0.2, target=bad,
                             cfg=tw.WalnutsConfig(m=4), num_iter=2,
                             device=cuda_device)
    assert rk.segment_launches - segs == 0


def _eager(monkeypatch):
    """Route the external-gradient periods through the eager segments."""
    monkeypatch.setattr(rk, "_launch", functools.partial(rk._launch,
                                                         graph=False))


def _banks_equal(a, b):
    """Every bank bit for bit, NaNs included."""
    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    for name, x, y in zip(rk.Banks._fields, a, b):
        t = bits[x.element_size()]
        assert torch.equal(x.view(t), y.view(t)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(TARGET_CASES))
def test_graphed_periods_equal_the_eager_segments_on_gpu(cuda_device,
                                                         monkeypatch, case,
                                                         dtype):
    """Each target without a fused gradient, 160 rounds (ten periods,
    each one replay of the captured graph at its own round) against the
    same invocation run as eager segments: every bank bit for bit, and
    no period ran eagerly for want of a capture."""
    make, stop_mode, unroll, warmup = TARGET_CASES[case]
    target = make()
    C = 48
    q0 = _q0(C, target.dim, cuda_device).to(dtype)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=5), num_iter=12,
              stop_mode=stop_mode, warmup=warmup, rounds=160, diag_rows=4,
              micro_unroll=unroll)
    h = torch.full((C,), 0.3, dtype=dtype, device=cuda_device)
    dl = torch.full((C,), 0.2, dtype=dtype, device=cuda_device)
    caps, eager = rk.graph_captures, rk.eager_periods
    graphed = mk.run_walnuts_fused(77, q0, h, dl, **kw)
    torch.cuda.synchronize()
    assert rk.graph_captures - caps == 1 and rk.eager_periods == eager
    assert rk._graphs == {}  # freed when the call returned
    with monkeypatch.context() as m:
        _eager(m)
        ref = mk.run_walnuts_fused(77, q0, h, dl, **kw)
    torch.cuda.synchronize()
    assert rk.graph_captures - caps == 1
    assert graphed[-1].n == ref[-1].n == 160
    _banks_equal(rk.pack(graphed[-1]), rk.pack(ref[-1]))
    assert graphed[4] == ref[4] > 0


@pytest.mark.cuda
def test_replays_at_two_rounds_give_the_eager_draws_on_gpu(cuda_device):
    """Two consecutive replays of one captured period, at rounds 0 and
    16, against the eager segments at the same rounds: bit for bit after
    each.  The second period from the same state at round 0 again
    differs, so a round base frozen in the graph would fail here."""
    target = tw.targets.smile()
    C = 64
    st = mk.init_state(_q0(C, 2, cuda_device), 0.3, 0.2, target=target,
                       cfg=tw.WalnutsConfig(m=5), warmup=None, num_iter=40,
                       diag_rows=4)
    spec = rk.RoundSpec(target=target, cfg=tw.WalnutsConfig(m=5),
                        warmup=None, stop_mode="per_chain", num_iter=40,
                        micro_unroll=3, seed=21)
    graphed, eager, frozen = rk.pack(st), rk.pack(st), rk.pack(st)
    caps = rk.graph_captures
    try:
        for n in (0, 16):
            rk.run_rounds(graphed, n, spec)
            rk._launch(eager, n, spec, graph=False)
            rk._launch(frozen, 0, spec, graph=False)
            torch.cuda.synchronize()
            _banks_equal(graphed, eager)
        assert rk.graph_captures - caps == 1 and len(rk._graphs) == 1
    finally:
        rk.release_graphs()
    assert not torch.equal(frozen.vx, eager.vx)


def _syncing_target():
    """``smile`` with an analytic gradient that waits for the card
    (``.item()``), which no CUDA graph can capture."""
    base = tw.targets.smile()

    def logp_grad(q):
        lp, g = base.logp_grad(q)
        lp.sum().item()  # waits for the card
        return lp, g

    return tw.Target(base._logp, 2, name="syncing", logp_grad=logp_grad)


@pytest.mark.cuda
def test_uncapturable_target_runs_the_eager_segments_on_gpu(cuda_device,
                                                            monkeypatch):
    """A target whose ``logp_grad`` calls ``.item()`` fails its capture:
    its periods run the eager segments on the same stream afterwards
    (one warning for the target over two calls, every period counted in
    ``eager_periods``), with the bits of the eager route."""
    target = _syncing_target()
    C = 32
    q0 = _q0(C, 2, cuda_device, seed=6)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=5), num_iter=12,
              stop_mode="per_chain", rounds=96, diag_rows=4, micro_unroll=2)
    eager, caps = rk.eager_periods, rk.graph_captures
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        outs = [mk.run_walnuts_fused(5, q0, 0.3, 0.2, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
    hits = [w for w in rec if "cannot be captured" in str(w.message)]
    assert len(hits) == 1 and "syncing.logp_grad" in str(hits[0].message)
    assert rk.eager_periods - eager == 2 * 96 // mk.FLUSH_EVERY
    assert rk.graph_captures == caps
    with monkeypatch.context() as m:
        _eager(m)
        ref = mk.run_walnuts_fused(5, q0, 0.3, 0.2, **kw)
    torch.cuda.synchronize()
    for out in outs:
        _banks_equal(rk.pack(out[-1]), rk.pack(ref[-1]))
    assert int(ref[3].sum()) > 0


@pytest.mark.cuda
def test_graph_cache_follows_micro_unroll_and_run_on_gpu(cuda_device):
    """One capture serves every period of the same banks and spec; a
    new ``micro_unroll`` captures anew; ``run_walnuts_fused`` frees the
    graphs it made when it returns."""
    target = tw.targets.corr_gauss()
    C = 32
    st = mk.init_state(_q0(C, 2, cuda_device), 0.3, 0.2, target=target,
                       cfg=tw.WalnutsConfig(m=5), warmup=None, num_iter=40,
                       diag_rows=4)
    spec = rk.RoundSpec(target=target, cfg=tw.WalnutsConfig(m=5),
                        warmup=None, stop_mode="per_chain", num_iter=40,
                        micro_unroll=4, seed=3)
    banks = rk.pack(st)
    caps, segs = rk.graph_captures, rk.segment_launches
    try:
        rk.run_rounds(banks, 0, spec)
        rk.run_rounds(banks, 16, spec)
        assert rk.graph_captures - caps == 1 and len(rk._graphs) == 1
        rk.run_rounds(banks, 32, spec._replace(micro_unroll=2))
        torch.cuda.synchronize()
        assert rk.graph_captures - caps == 2 and len(rk._graphs) == 2
        assert rk.segment_launches - segs == 2 * 65 + 33
    finally:
        rk.release_graphs()
    assert rk._graphs == {}
    mk.run_walnuts_fused(3, _q0(C, 2, cuda_device), 0.3, 0.2, target=target,
                         cfg=tw.WalnutsConfig(m=5), num_iter=4, rounds=48,
                         micro_unroll=4)
    assert rk.graph_captures - caps == 3 and rk._graphs == {}
