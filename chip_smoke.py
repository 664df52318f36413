#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``walnuts_tpu_torch``) on one GPU.

Builds the hand-written round kernel from the checkout's sources, holds
it against its plain PyTorch twin on the card, then drives the
benchmark's main path once through the public entry point: Neal's
funnel in 101 dimensions, 8192 chains in float32, m=8, 700 transitions
of pooled in-loop warmup in ``per_chain`` mode, then 300 draws per
chain in ``min_per_chain`` mode with ``micro_unroll=4`` and the
``(omega, sum x^2)`` summary.  It checks the exact omega ~ N(0, 3^2)
marginal and prints grad-evals/s and min-ESS/s.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (the build goes to
``walnuts_tpu_torch/build/``); without them it fails and prints no
result.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the line before it lists each kernel with its launches on the
main path, its largest error against the plain twin and both times.
The line after the device line is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def log(msg):
    print(msg, flush=True)


def main():
    if not (HERE / "walnuts_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: walnuts_tpu_torch/ is not beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(HERE))
    import torch

    # ---- phase 0: device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0 device: torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind} | count {torch.cuda.device_count()}")
    log(smi[0] if smi else "nvidia-smi: unavailable")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    from walnuts_tpu_torch import _build
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch.sampler import megakernel as mk
    from walnuts_tpu_torch.sampler import round_kernel as rk

    phase_build(_build)
    phase_f64(tw, mk, rk, dev)
    max_abs_err = phase_f32(tw, mk, rk, dev)
    warm, launches = phase_main(tw, mk, rk, dev)
    ms, plain_ms = phase_timing(tw, mk, rk, dev, warm)
    log(json.dumps({"kernels": [{
        "name": "walnuts_round_kernel",
        "route": "cuda",
        "source": "walnuts_tpu_torch/csrc/round_kernel.cu",
        "replaces": "walnuts_tpu/sampler/pallas_megakernel.py:158",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def phase_build(_build):
    t0 = time.perf_counter()
    path, out = _build.build()
    _build.load()
    log(f"phase 1 build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _banks_compare(a, b, *, rtol, atol, slab_rtol=None, chains=None):
    """Largest abs float difference between two bank sets; raises when
    integer banks differ (on ``chains`` only, if given) or floats
    disagree beyond ``rtol``/``atol`` (``slab_rtol`` in place of ``rtol``
    for the span slabs)."""
    import torch

    sel = slice(None) if chains is None else chains
    si_a, si_b = a.si[:, sel], b.si[:, sel]
    if not torch.equal(si_a, si_b):
        rows = (si_a != si_b).any(1).nonzero().flatten().tolist()
        raise AssertionError(f"integer banks differ in rows {rows}")
    worst = 0.0
    for name, x, y in (("sf", a.sf[:, sel], b.sf[:, sel]),
                       ("vx", a.vx[:, sel], b.vx[:, sel]),
                       ("slab_q", a.slab_q[sel], b.slab_q[sel]),
                       ("slab_v", a.slab_v[sel], b.slab_v[sel]),
                       ("samples", a.samples[:, sel], b.samples[:, sel]),
                       ("diags", a.diags[:, sel], b.diags[:, sel])):
        slab = name.startswith("slab")
        r = slab_rtol if slab and slab_rtol is not None else rtol
        x, y = x.double(), y.double()
        fin = torch.isfinite(x) & torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)) or \
                not torch.equal(x[~fin], y[~fin]):
            raise AssertionError(f"{name}: non-finite entries differ")
        d = (x[fin] - y[fin]).abs()
        bad = d > atol + r * y[fin].abs()
        if bad.any():
            raise AssertionError(
                f"{name}: {int(bad.sum())} entries beyond rtol {r} atol "
                f"{atol}; max abs diff {float(d.max()):.3e}")
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst


def _pair(tw, mk, rk, dev, *, D, C, m, dtype, rounds, warmup=None,
          stop_mode="min_per_chain", num_iter=50, micro_unroll=1,
          generated=None, ring_rows=None):
    """Run the same capped invocation through the kernel and the plain
    twin; return both final bank sets."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1234)
    q0 = (0.3 * torch.randn(C, D, generator=g, dtype=torch.float64)).to(
        device=dev, dtype=dtype)
    kw = dict(target=tw.targets.funnel(D, generated=generated),
              cfg=tw.WalnutsConfig(m=m), num_iter=num_iter,
              stop_mode=stop_mode, warmup=warmup, rounds=rounds,
              ring_rows=ring_rows, diag_rows=8, micro_unroll=micro_unroll)
    h = torch.full((C,), 0.4, dtype=dtype, device=dev)
    dl = torch.full((C,), 0.15, dtype=dtype, device=dev)
    before = rk.launches
    st_k = mk.run_walnuts_fused(987654, q0, h, dl, **kw)[-1]
    torch.cuda.synchronize()
    if rk.launches <= before:
        raise AssertionError("the kernel path made no launch")
    st_p = mk.run_walnuts_fused_plain(987654, q0, h, dl, **kw)[-1]
    torch.cuda.synchronize()
    return rk.pack(st_k), rk.pack(st_p)


def phase_f64(tw, mk, rk, dev):
    """Exact contract: float64, integer banks equal, floats to 1e-9."""
    import torch

    cases = [
        ("funnel(7) C=64 m=4 min_per_chain", dict(D=7, C=64, m=4)),
        ("funnel(7) C=64 m=4 pooled warmup per_chain micro_unroll=4",
         dict(D=7, C=64, m=4, stop_mode="per_chain", num_iter=20,
              micro_unroll=4,
              warmup=tw.WarmupConfig(warmup_iter=20, pooled=True))),
        ("funnel(101) C=512 m=8 min_per_chain", dict(D=101, C=512, m=8)),
    ]
    for name, kw in cases:
        a, b = _pair(tw, mk, rk, dev, dtype=torch.float64, rounds=160, **kw)
        err = _banks_compare(a, b, rtol=1e-9, atol=1e-12)
        log(f"phase 2 f64 kernel == plain: {name}: 160 rounds, integer "
            f"banks equal, max abs float diff {err:.3e} (rtol 1e-9, "
            f"atol 1e-12); draws {int(a.si[1].sum())}")


def phase_f32(tw, mk, rk, dev):
    """float32 with the bf16 slab, one 16-round launch: integer state on
    >= 99% of chains, floats on those chains to rtol 1e-4.

    The kernel and the twin sum in other orders and the kernel contracts
    multiply-adds, so each float carries a few ulps of its own.  The
    last two cases are the main path's two launch shapes (warmup and
    timed) at its 8192 chains.  There some floats are differences of two
    energies of size ~100 (``dha``, ``h_max - h_min``, the P2 inputs
    ``log igr`` and ``(h_max - h_min) / delta``), whose absolute error is
    a few float32 ulps of 100 (~1e-5 each), so atol is 1e-3; a slab
    entry may land one bf16 ulp apart (2^-7 relative)."""
    import torch

    cases = [
        ("funnel(101) C=512 m=8 min_per_chain", dict(C=512),
         dict(rtol=1e-4, atol=1e-4)),
        ("funnel(101) C=8192 m=8 pooled warmup per_chain ring_rows=8 "
         "(main path, warmup)",
         dict(C=8192, stop_mode="per_chain", num_iter=700, ring_rows=8,
              warmup=tw.WarmupConfig(warmup_iter=700, pooled=True)),
         dict(rtol=1e-4, atol=1e-3, slab_rtol=2.0 ** -7)),
        ("funnel(101) C=8192 m=8 min_per_chain N=300 micro_unroll=4 "
         "(omega, sum x^2) (main path, timed)",
         dict(C=8192, num_iter=300, micro_unroll=4,
              generated=tw.targets.omega_sumsq),
         dict(rtol=1e-4, atol=1e-3, slab_rtol=2.0 ** -7)),
    ]
    worst = 0.0
    for name, kw, tol in cases:
        a, b = _pair(tw, mk, rk, dev, D=101, m=8, dtype=torch.float32,
                     rounds=16, **kw)
        agree = (a.si == b.si).all(0)
        frac = float(agree.float().mean())
        if frac < 0.99:
            raise AssertionError(
                f"{name}: integer state agrees on {frac:.4f} of chains")
        cols = agree.nonzero().flatten()
        err = _banks_compare(
            rk.Banks(a.sf, a.si, a.vx, a.slab_q.float(), a.slab_v.float(),
                     a.samples, a.diags),
            rk.Banks(b.sf, b.si, b.vx, b.slab_q.float(), b.slab_v.float(),
                     b.samples, b.diags), chains=cols, **tol)
        slab = max(float((a.slab_q[cols].float() - b.slab_q[cols].float())
                         .abs().max()),
                   float((a.slab_v[cols].float() - b.slab_v[cols].float())
                         .abs().max()))
        tol_s = ", ".join(f"{k} {v:g}" for k, v in tol.items())
        log(f"phase 3 f32/bf16 kernel vs plain: {name}, 16 rounds: integer "
            f"state equal on {frac:.4f} of chains; on those, max abs float "
            f"diff {err:.3e} ({tol_s}), slab max abs diff {slab:.3e}; draws "
            f"{int(a.si[1].sum())}")
        worst = max(worst, err)
    return worst


def phase_main(tw, mk, rk, dev):
    """The benchmark's main path through the public entry point."""
    import torch
    from walnuts_tpu_torch.diagnostics import ess

    C, D, M, WARMUP, ITERS = 8192, 101, 8, 700, 300
    g = torch.Generator(device=dev).manual_seed(0)
    q0 = 0.3 * torch.randn(C, D, generator=g, device=dev,
                           dtype=torch.float32)
    h0 = torch.full((C,), 0.3, device=dev)
    d0 = torch.full((C,), 0.3, device=dev)
    cfg = tw.WalnutsConfig(m=M)
    rk.launches = 0

    # warmup: round-capped invocations that resume through mk_state
    wu = tw.WarmupConfig(warmup_iter=WARMUP, pooled=True)
    kw = dict(target=tw.targets.funnel(D), cfg=cfg, num_iter=WARMUP,
              warmup=wu, ring_rows=8, rounds=2500)
    t0 = time.perf_counter()
    st, calls = None, 0
    while True:
        out = mk.run_walnuts_fused(11, q0, h0, d0, mk_state=st, **kw)
        st = out[-1]
        calls += 1
        if calls % 25 == 0:
            log(f"  warmup: {int(st.it.min())}/{WARMUP} after "
                f"{time.perf_counter() - t0:.1f} s")
        if int(st.it.min()) >= WARMUP:
            break
        if time.perf_counter() - t0 > 600:
            raise AssertionError(f"warmup reached {int(st.it.min())} of "
                                 f"{WARMUP} transitions in 600 s")
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm = st
    warm_launches = rk.launches

    # timed sampling: min_per_chain, micro_unroll=4, (omega, sum x^2)
    target = tw.targets.funnel(D, generated=tw.targets.omega_sumsq)
    kw = dict(target=target, cfg=cfg, num_iter=ITERS,
              stop_mode="min_per_chain", diag_rows=8, micro_unroll=4,
              rounds=12000)
    t_warm_calls = calls
    t0 = time.perf_counter()
    st, calls = None, 0
    while True:
        out = mk.run_walnuts_fused(13, warm.qc, warm.h_cur, warm.delta_cur,
                                   mk_state=st, **kw)
        st = out[-1]
        calls += 1
        if int(st.it.min()) >= ITERS:
            break
        if time.perf_counter() - t0 > 400:
            raise AssertionError(f"timed phase reached {int(st.it.min())} "
                                 f"of {ITERS} draws in 400 s")
    torch.cuda.synchronize()
    t_timed = time.perf_counter() - t0
    launches = rk.launches
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")

    grads = int(st.grad_ct.to(torch.int64).sum())
    draws = st.samples.double()                       # [300, C, 2]
    if tuple(draws.shape) != (ITERS, C, 2) or \
            not bool(torch.isfinite(draws).all()):
        raise AssertionError(f"bad draws: shape {tuple(draws.shape)}")
    ess_vals = ess(draws)
    min_ess_s = float(ess_vals.min()) / t_timed
    sd_err = abs(float(draws[..., 0].std()) - 3.0)
    log(f"phase 4 main path: funnel(101) C={C} m={M} f32: warmup "
        f"{WARMUP} pooled in {t_warm:.2f} s over {t_warm_calls} calls of "
        f"2500 rounds (adapted H median "
        f"{float(warm.h_cur.median()):.4f}, delta median "
        f"{float(warm.delta_cur.median()):.4f}); timed {ITERS} draws in "
        f"{t_timed:.2f} s over {calls} calls of 12000 rounds: {grads} grad "
        f"evals = {grads / t_timed:.1f} grad-evals/s, ESS (omega, sum x^2) = "
        f"{[round(float(e), 1) for e in ess_vals]}, min-ESS/s "
        f"{min_ess_s:.2f}, |sd(omega) - 3| = {sd_err:.4f}, kernel launches "
        f"{launches} ({warm_launches} warmup, {launches - warm_launches} "
        f"timed)")
    if not sd_err < 0.3:
        raise AssertionError(f"|sd(omega) - 3| = {sd_err:.4f} >= 0.3")
    return warm, launches


def phase_timing(tw, mk, rk, dev, warm):
    """256 rounds at the main path's shape, plain and kernel in turns."""
    import torch

    target = tw.targets.funnel(101, generated=tw.targets.omega_sumsq)
    st0 = mk.init_state(warm.qc, warm.h_cur, warm.delta_cur, target=target,
                        cfg=tw.WalnutsConfig(m=8), warmup=None, num_iter=300,
                        diag_rows=8)
    spec = rk.RoundSpec(target=target, cfg=tw.WalnutsConfig(m=8),
                        warmup=None, stop_mode="min_per_chain",
                        num_iter=300, micro_unroll=4, seed=13)
    periods = 256 // mk.FLUSH_EVERY

    def timed(fn):
        banks = rk.pack(st0)
        fn(banks, 0, spec)  # warm the path
        banks = rk.pack(st0)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for i in range(periods):
            fn(banks, i * mk.FLUSH_EVERY, spec)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / periods

    launches = rk.launches
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = rk.run_rounds_plain if name == "plain" else rk.run_rounds
        times[name].append(timed(fn))
    rk.launches = launches  # comparison launches do not count
    ms = min(times["kernel"])
    plain_ms = min(times["plain"])
    log(f"phase 5 timing: funnel(101) C=8192 m=8 f32 micro_unroll=4, 256 "
        f"rounds: kernel {ms:.3f} ms per 16-round launch "
        f"({[round(t, 3) for t in times['kernel']]}), plain "
        f"{plain_ms:.3f} ms ({[round(t, 3) for t in times['plain']]}), "
        f"ratio {plain_ms / ms:.1f}x")
    return ms, plain_ms


if __name__ == "__main__":
    main()
