#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``walnuts_tpu_torch``) on one GPU.

Builds the hand-written round kernel from the checkout's sources, holds
it against its plain PyTorch twin on the card, then drives the
benchmark's main path once through the public entry point: Neal's
funnel in 101 dimensions, 8192 chains in float32, m=8, 700 transitions
of pooled in-loop warmup in ``per_chain`` mode, then 300 draws per
chain in ``min_per_chain`` mode with ``micro_unroll=4`` and the
``(omega, sum x^2)`` summary.  It checks the exact omega ~ N(0, 3^2)
marginal and prints grad-evals/s and min-ESS/s.  Phase 6 runs the scan
engine ``run_walnuts`` on the card: float64 against the CPU, then the
README Quick start's width (funnel(101), 4096 chains, m=10, R2P) for a
few transitions, with its wall, gradient evaluations and depths.
Phase 7 runs the streaming engine ``run_walnuts_streaming`` the same
way, from phase 6's adapted chains; phase 8 runs generic-step NUTS and
the multinomial sampler (float64 against the CPU), then config 5's
``iso_std`` arm (``examples/highdim_variants.py``: isokinetic kernel,
D = 10^4, 32 chains) with its ESS per 1000 gradient evaluations.  None
of these three engines reaches a hand-written kernel (nor does their
JAX counterpart reach a Pallas kernel), so each phase also prints the
round kernel's launch count over its run: 0.  Phase 9 runs the
Stock-Watson model (D = 756) through the fused engine, whose kernel
fuses its gradient: float64 kernel against twin under the example's
three protocols, then the example's walnuts_d arm at 256 chains with
its speed, kernel time beside its bound and medians beside the
committed example's bands; 9c holds the paper-pseudocode mode and the
Monge integrators on the card against the CPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (the build goes to
``walnuts_tpu_torch/build/``); without them it fails and prints no
result.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the line before it lists each kernel with its launches on the
main path, its largest error against the plain twin, both times, the
least time the card could take for a launch's work (``bound_ms``) and
the main-path instantiation's registers and resident warps per SM.  The
line after the device line is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CARD = "card not read"  # nvidia-smi's name and power limit, set in main()
# One H100 SXM at its published peaks (NVIDIA's data sheet): HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# Float operations a gradient evaluation costs per coordinate: the two
# half kicks and the drift (3 multiply-adds), the two squared norms
# (2 multiply-adds) and the gradient (1 multiply), 2 operations each.
FLOPS_PER_COORD = 12
# Stock-Watson's micro step per coordinate: the leapfrog's 3
# multiply-adds and the kinetic energy's 1 (8 operations), and its
# gradient, which per series index (three coordinates) does 3 prefix
# and 3 suffix scan additions, 5 multiply-adds for the states and the
# innovations' squares, 3 exponentials (counted as one operation
# each), 7 multiplies and 6 additions for the residual terms and c,
# and 4 multiply-adds for the gradient entries and the tSigma dots:
# 3 + 3 + 10 + 3 + 7 + 6 + 8 = 40 per index, 14 per coordinate.
SW_FLOPS_PER_COORD = 8 + 14


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
    global CARD
    CARD = smi[0] if smi else "nvidia-smi: unavailable"
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

    attrs = phase_build(_build, rk)
    phase_f64(tw, mk, rk, dev)
    max_abs_err = phase_f32(tw, mk, rk, dev)
    warm, launches = phase_main(tw, mk, rk, dev)
    ms, plain_ms, bound_ms, bound_by = phase_timing(tw, mk, rk, dev, warm)
    scan_state, scan_s_per_it = phase_scan(tw, rk, dev)
    phase_stream(tw, rk, dev, scan_state, scan_s_per_it)
    phase_iso(tw, rk, dev)
    sw = phase_sw(tw, mk, rk, dev)
    phase_modes(tw, rk, dev)
    kernel = {"route": "cuda",
              "source": "walnuts_tpu_torch/csrc/round_kernel.cu",
              "replaces": "walnuts_tpu/sampler/pallas_megakernel.py:158",
              "library_ms": None}
    log(json.dumps({"kernels": [
        dict(kernel, name="walnuts_round_kernel", launches=launches,
             max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, regs=attrs["regs"],
             warps_per_sm=attrs["warps_per_sm"]),
        dict(kernel, name="walnuts_round_kernel[stock_watson]", **sw)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def phase_build(_build, rk):
    """Build, then for every kernel instantiation print ptxas's stack,
    spill and register lines and the runtime's resident warps per SM.
    Returns the main path's instantiation's attributes."""
    import torch

    t0 = time.perf_counter()
    path, out = _build.build()
    _build.load()
    log(f"phase 1 build: {path.name} in {time.perf_counter() - t0:.1f} s")
    lines = (out or path.with_suffix(".log").read_text()).splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '_Z12round_kernelI(f|d)\w*?"
                      r"Li(\d)ELi(\d)E", line)
        if m:
            stack = next(x for x in lines[i + 1:] if "stack frame" in x)
            used = next(x for x in lines[i + 1:] if "Used" in x)
            ptxas[m.groups()] = (f"{stack.strip()}; "
                                 f"{used.split(':')[1].strip()}")
    shapes = [(tgt, tid, D) for tgt, tid in (("funnel", "0"),
                                             ("std_gauss", "1"))
              for D in (32, 64, 96, 128, 160)]  # DPL 1-4, then 0 (D > 128)
    shapes.append(("stock_watson", "2", 756))  # DPL 0 at every D
    for prec, dtype in (("f", torch.float32), ("d", torch.float64)):
        for tgt, tid, D in shapes:
            a = rk.kernel_attributes(dtype, tgt, D)
            dpl = a["dpl"]
            log(f"  round_kernel<{dtype}, {tgt}, DPL={dpl}>: ptxas "
                f"{ptxas.get((prec, tid, str(dpl)), 'not found')} | "
                f"runtime {a['regs']} registers, {a['local_bytes']} "
                f"local bytes, {a['warps_per_sm']} warps/SM")
    main = rk.kernel_attributes(torch.float32, "funnel", 101)
    log(f"  main path (float32 funnel, D=101): {main}")
    return main


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
                       ("vx", a.vx[sel], b.vx[sel]),
                       ("slab_q", a.slab_q[sel], b.slab_q[sel]),
                       ("slab_v", a.slab_v[sel], b.slab_v[sel]),
                       ("samples", a.samples[:, sel], b.samples[:, sel]),
                       ("diags", a.diags[:, sel], b.diags[:, sel])):
        slab = name.startswith("slab")
        r = slab_rtol if slab and slab_rtol is not None else rtol
        x, y = x.double(), y.double()
        fin = torch.isfinite(x) & torch.isfinite(y)
        inf = torch.isinf(x)  # NaN entries must sit at the same places
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)) or \
                not torch.equal(torch.isnan(x), torch.isnan(y)) or \
                not torch.equal(x[inf], y[inf]):
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
          generated=None, ring_rows=None, target=None, seed=987654,
          q_seed=1234, delta=0.15, diag_rows=8):
    """Run the same capped invocation (of funnel(D) unless ``target`` is
    given) through the kernel and the plain twin; return both final bank
    sets."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(q_seed)
    q0 = (0.3 * torch.randn(C, D, generator=g, dtype=torch.float64)).to(
        device=dev, dtype=dtype)
    kw = dict(target=target or tw.targets.funnel(D, generated=generated),
              cfg=tw.WalnutsConfig(m=m), num_iter=num_iter,
              stop_mode=stop_mode, warmup=warmup, rounds=rounds,
              ring_rows=ring_rows, diag_rows=diag_rows,
              micro_unroll=micro_unroll)
    h = torch.full((C,), 0.4, dtype=dtype, device=dev)
    dl = torch.full((C,), delta, dtype=dtype, device=dev)
    before = rk.launches
    st_k = mk.run_walnuts_fused(seed, q0, h, dl, **kw)[-1]
    torch.cuda.synchronize()
    if rk.launches <= before:
        raise AssertionError("the kernel path made no launch")
    st_p = mk.run_walnuts_fused_plain(seed, q0, h, dl, **kw)[-1]
    torch.cuda.synchronize()
    return rk.pack(st_k), rk.pack(st_p)


def phase_f64(tw, mk, rk, dev):
    """Exact contract: float64, integer banks equal, floats to 1e-9.

    The rtol/atol pairs written out in this phase are the ``EXACT`` and
    ``ADAPTIVE`` contracts of ``walnuts_tpu_torch.utils.parity``."""
    import torch

    cases = [
        ("funnel(7) C=64 m=4 min_per_chain", dict(D=7, C=64, m=4)),
        ("funnel(7) C=64 m=4 pooled warmup per_chain micro_unroll=4",
         dict(D=7, C=64, m=4, stop_mode="per_chain", num_iter=20,
              micro_unroll=4,
              warmup=tw.WarmupConfig(warmup_iter=20, pooled=True))),
        ("funnel(101) C=512 m=8 min_per_chain", dict(D=101, C=512, m=8)),
        ("funnel(101) C=512 m=8 min_per_chain micro_unroll=4 (the main "
         "path's width, depth and unroll)",
         dict(D=101, C=512, m=8, micro_unroll=4)),
    ]
    it = rk.I_FIELDS.index("it")
    for name, kw in cases:
        a, b = _pair(tw, mk, rk, dev, dtype=torch.float64, rounds=160, **kw)
        err = _banks_compare(a, b, rtol=1e-9, atol=1e-12)
        log(f"phase 2 f64 kernel == plain: {name}: 160 rounds, integer "
            f"banks equal, max abs float diff {err:.3e} (rtol 1e-9, "
            f"atol 1e-12); draws {int(a.si[it].sum())}")
    # The adaptive contract (walnuts_tpu_torch.utils.parity): with
    # per-chain warmup at D=80 the JAX engine and the twin drift past the
    # exact contract on the CPU (tests/test_torch_megakernel.py), so the
    # kernel is held to the bound they meet, on the same inputs and hash
    # seed.
    a, b = _pair(tw, mk, rk, dev, D=80, C=48, m=5, dtype=torch.float64,
                 rounds=160, target=tw.targets.std_gauss(80),
                 warmup=tw.WarmupConfig(warmup_iter=8), stop_mode="per_chain",
                 num_iter=12, seed=506380528, q_seed=5, delta=0.2,
                 diag_rows=4)
    err = _banks_compare(a, b, rtol=1e-8, atol=1e-9)
    try:
        _banks_compare(a, b, rtol=1e-9, atol=1e-12)
        strict = "holds"
    except AssertionError as e:
        strict = f"does not hold ({e})"
    log(f"phase 2 f64 kernel vs plain: std_gauss(80) C=48 m=5 per-chain "
        f"warmup: 160 rounds, integer banks equal, max abs float diff "
        f"{err:.3e} (rtol 1e-8, atol 1e-9); the exact contract {strict}")


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
    it = rk.I_FIELDS.index("it")
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
            f"{int(a.si[it].sum())}")
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


def _bound(rk, b0, b1, periods, warmup, flops_per_coord=FLOPS_PER_COORD):
    """Least ms a launch could take on an H100 SXM for the work between
    bank sets ``b0`` and ``b1`` (``periods`` launches apart): the larger
    of two times.  One is the bytes over the HBM rate: the state that is
    live across a launch, read once and written once (the scalar rows,
    the P2 estimators' rows only under ``warmup``, the vectors at their
    D columns, the slabs), plus the ring rows the draws write.  The two
    pending slots' staging rows are empty when a launch starts and when
    it ends, so they are left out.  The other is the gradient
    evaluations' float operations over the float32 rate.  Returns
    ``(ms, "bytes" or "operations", detail)``."""
    C, S, D = b0.slab_q.shape
    isz = b0.vx.element_size()
    p2 = warmup is not None
    f_rows = len(rk.F_FIELDS) + (2 * rk.P2_F_ROWS if p2 else 0)
    i_rows = rk.I_BOOL + len(rk.B_FIELDS) + (2 * rk.P2_I_ROWS if p2 else 0)
    state = (C * f_rows * isz + C * i_rows * b0.si.element_size()
             + C * len(rk.V_FIELDS) * D * isz
             + b0.slab_q.nbytes + b0.slab_v.nbytes)
    it, gc = rk.I_FIELDS.index("it"), rk.I_FIELDS.index("grad_ct")
    draws = int((b1.si[it].long() - b0.si[it].long()).sum()) / periods
    grads = int((b1.si[gc].long() - b0.si[gc].long()).sum()) / periods
    nbytes = 2 * state + draws * (b0.samples.shape[2] + 24) * isz
    byte_ms = nbytes / HBM_BYTES_S * 1e3
    op_ms = grads * D * flops_per_coord / F32_FLOP_S * 1e3
    gflop = grads * D * flops_per_coord / 1e9
    detail = (f"{nbytes / 1e6:.1f} MB moved ({2 * state / 1e6:.1f} MB of "
              f"state in and out) = {byte_ms:.4f} ms at 3.35 TB/s; "
              f"{grads:.0f} grad evals = {gflop:.3f} GFLOP = {op_ms:.4f} ms "
              f"at 67 TFLOP/s")
    if byte_ms >= op_ms:
        return byte_ms, "bytes", detail
    return op_ms, "operations", detail


def phase_timing(tw, mk, rk, dev, warm):
    """256 rounds at the main path's two launch shapes from the warmed
    chains: the timed shape plain and kernel in turns, the warmup shape
    kernel only; each beside its bound."""
    import torch

    cfg = tw.WalnutsConfig(m=8)
    timed_target = tw.targets.funnel(101, generated=tw.targets.omega_sumsq)
    wu = tw.WarmupConfig(warmup_iter=700, pooled=True)
    shapes = {
        "timed": (mk.init_state(warm.qc, warm.h_cur, warm.delta_cur,
                                target=timed_target, cfg=cfg, warmup=None,
                                num_iter=300, diag_rows=8),
                  rk.RoundSpec(target=timed_target, cfg=cfg, warmup=None,
                               stop_mode="min_per_chain", num_iter=300,
                               micro_unroll=4, seed=13)),
        "warmup": (mk.init_state(warm.qc, warm.h_cur, warm.delta_cur,
                                 target=tw.targets.funnel(101), cfg=cfg,
                                 warmup=wu, num_iter=700, ring_rows=8),
                   rk.RoundSpec(target=tw.targets.funnel(101), cfg=cfg,
                                warmup=wu, stop_mode="per_chain",
                                num_iter=700, micro_unroll=1, seed=11)),
    }
    periods = 256 // mk.FLUSH_EVERY

    def timed(fn, shape):
        st0, spec = shapes[shape]
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
        return e0.elapsed_time(e1) / periods, banks

    launches = rk.launches
    times = {"plain": [], "kernel": [], "warmup": []}
    after = {}  # each shape's kernel banks after the timed launches
    for name in ("plain", "kernel", "warmup", "kernel", "warmup", "plain"):
        fn = rk.run_rounds_plain if name == "plain" else rk.run_rounds
        shape = "warmup" if name == "warmup" else "timed"
        t, banks = timed(fn, shape)
        times[name].append(t)
        if name != "plain":
            after.setdefault(shape, banks)
    rk.launches = launches  # comparison launches do not count
    ms = min(times["kernel"])
    plain_ms = min(times["plain"])
    bounds = {k: _bound(rk, rk.pack(shapes[k][0]), b, periods,
                        shapes[k][1].warmup)
              for k, b in after.items()}
    log(f"phase 5 timing: funnel(101) C=8192 m=8 f32 micro_unroll=4, 256 "
        f"rounds: kernel {ms:.4f} ms per 16-round launch "
        f"({[round(t, 4) for t in times['kernel']]}), plain "
        f"{plain_ms:.3f} ms ({[round(t, 3) for t in times['plain']]}), "
        f"ratio {plain_ms / ms:.1f}x; bound {bounds['timed'][0]:.4f} ms "
        f"({bounds['timed'][1]}: {bounds['timed'][2]}), kernel at "
        f"{bounds['timed'][0] / ms:.1%} of it")
    wms = min(times["warmup"])
    log(f"phase 5 timing, warmup shape (pooled warmup, micro_unroll=1, "
        f"identity summary): kernel {wms:.4f} ms per 16-round launch "
        f"({[round(t, 4) for t in times['warmup']]}); bound "
        f"{bounds['warmup'][0]:.4f} ms ({bounds['warmup'][1]}: "
        f"{bounds['warmup'][2]}), kernel at "
        f"{bounds['warmup'][0] / wms:.1%} of it")
    return ms, plain_ms, bounds["timed"][0], bounds["timed"][1]


# Phase 6 runs the README Quick start's width for this many warmup and
# sampling transitions: at least 10 each, so that delta adaptation (from
# iteration 11) runs, and few enough to keep the phase near 120 s.
SCAN_WARMUP, SCAN_ITERS = 12, 12
SCAN_CHAINS, SCAN_DIM = 4096, 101     # the Quick start's C and funnel(D)
STOP_CODES = (0, 4, -4, 5, 999)


def _scan_check(name, s, d, C, D, lead=1):
    """A WALNUTS engine's outputs: finite samples of the expected shape
    (``lead`` rows before the first transition's), stop codes in the
    contract's set."""
    import torch

    n = d.shape[0]
    if tuple(s.shape) != (n + lead, C, D) or tuple(d.shape) != (n, C, 24):
        raise AssertionError(f"{name}: shapes {tuple(s.shape)}, "
                             f"{tuple(d.shape)}")
    if not bool(torch.isfinite(s).all()):
        raise AssertionError(f"{name}: non-finite samples")
    codes = set(int(x) for x in torch.unique(d[..., 19]).tolist())
    if not codes <= set(STOP_CODES):
        raise AssertionError(f"{name}: stop codes {sorted(codes)}")
    return codes


def phase_scan(tw, rk, dev):
    """The scan engine ``run_walnuts`` on the card (it runs plain torch:
    the JAX scan engine reaches no Pallas kernel).  (a) float64
    funnel(11), C=64, m=5, 20 iterations without warmup, on the card and
    on the CPU: integer diagnostics equal, floats within the exact
    contract.  (b) the README Quick start's width: funnel(101), 4096
    chains, m=10, R2P, float32, h0 = delta0 = 0.3, per-chain warmup.
    Returns (b)'s final ``SamplerState`` and its wall per transition."""
    import numpy as np
    import torch
    from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

    int_cols = [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22]
    float_cols = [i for i in range(24) if i not in int_cols]
    C, D = 64, 11
    q0 = 0.5 * np.random.default_rng(0).normal(size=(C, D))
    kw = dict(target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=5),
              warmup=tw.WarmupConfig(warmup_iter=0), num_iter=20, h0=0.4,
              delta0=0.15)
    t0 = time.perf_counter()
    s_g, d_g, st_g = tw.run_walnuts(5, q0, device=dev, **kw)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_c, d_c, st_c = tw.run_walnuts(5, q0, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    if s_g.device.type != "cuda":
        raise AssertionError("run_walnuts did not run on the card")
    d_g, d_c = d_g.cpu().numpy(), d_c.numpy()
    np.testing.assert_array_equal(d_g[..., int_cols], d_c[..., int_cols])
    assert_parity(d_c[..., float_cols], d_g[..., float_cols], EXACT, "diag")
    assert_parity(s_c.numpy(), s_g.cpu().numpy(), EXACT, "samples")
    err = max(float(np.abs(s_g.cpu().numpy() - s_c.numpy()).max()),
              float(np.nanmax(np.abs(d_g[..., float_cols]
                                     - d_c[..., float_cols]))))
    _scan_check("6a", s_g, torch.from_numpy(d_g), C, D)
    log(f"phase 6a scan engine f64 card == CPU: funnel(11) C=64 m=5 R2P, "
        f"20 iterations: integer diagnostics equal, max abs float diff "
        f"{err:.3e} (rtol {EXACT['rtol']:g}, atol {EXACT['atol']:g}); "
        f"grad evals {int(d_g[..., 6].sum() + d_g[..., 7].sum())}; wall "
        f"{t_gpu:.2f} s on the card, {t_cpu:.2f} s on the CPU")

    # (b) full width; the counts are reset and read around the run: the
    # scan path launches no hand-written kernel
    C, D = SCAN_CHAINS, SCAN_DIM
    g = torch.Generator(device=dev).manual_seed(0)
    q0 = 0.1 * torch.randn(C, D, generator=g, device=dev)
    n = SCAN_WARMUP + SCAN_ITERS
    rk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, d, st = tw.run_walnuts(
        7, q0, target=tw.targets.funnel(D),
        cfg=tw.WalnutsConfig(m=10, integrator="adapt_leapfrog_r2p"),
        warmup=tw.WarmupConfig(warmup_iter=SCAN_WARMUP), num_iter=n,
        h0=0.3, delta0=0.3, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan_launches = rk.launches
    s_per_it = wall / n
    codes = _scan_check("6b", s, d, C, D)
    grads = int(d[..., 6].double().sum() + d[..., 7].double().sum())
    per_it = d[..., 6].double().sum(-1) + d[..., 7].double().sum(-1)
    log(f"phase 6b scan engine, README width: funnel(101) C={C} m=10 R2P "
        f"f32, per-chain warmup {SCAN_WARMUP} + {SCAN_ITERS} sampling "
        f"transitions in {wall:.2f} s = {wall / n:.3f} s per transition; "
        f"{grads} grad evals = {grads / wall:.1f} grad-evals/s (per "
        f"iteration {[int(x) for x in per_it.tolist()]}); worst refinement "
        f"depth (c_max) {int(d[..., 22].max())}, worst orbit depth "
        f"{int(d[..., 20].max())}, mean orbit depth "
        f"{float(d[..., 20].double().mean()):.2f}; stop codes "
        f"{sorted(codes)}; |omega| finite, max {float(s[..., 0].abs().max()):.3f}; "
        f"H median {float(st.h.median()):.4f}, delta median "
        f"{float(st.delta.median()):.4f}; round-kernel launches "
        f"{scan_launches}")

    # the card's busy share over one more transition, under torch.profiler
    log("phase 6b profile, one more sampling transition: " + _profiled(
        lambda: tw.run_walnuts(
            8, resume_state=st, target=tw.targets.funnel(D),
            cfg=tw.WalnutsConfig(m=10), num_iter=1,
            warmup=tw.WarmupConfig(warmup_iter=SCAN_WARMUP),
            device=dev))[0])
    return st, s_per_it


def _profiled(fn):
    """Run ``fn`` under torch.profiler and say how busy the card was:
    the device kernels' summed time against the wall.  Returns that
    text and the number of device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    kernels = sum(e.count for e in events)
    return (f"card busy {busy:.3f} s of {wall:.3f} s wall under the "
            f"profiler ({busy / wall:.1%}), {kernels} device kernels "
            f"({wall / max(kernels, 1) * 1e6:.1f} us of wall per kernel)",
            kernels)


# Phase 7b streams this many transitions per chain at the README width
# from 6b's adapted state (the README runs 2000; the cut keeps the run
# near 40 s at the ~4 s per transition this phase measured on an H100,
# so that the whole smoke, phase 9 included, stays near 600 s).
STREAM_ITERS = 10
# Phase 8b runs config 5's iso_std arm (D = 10^4, 32 chains, m = 9;
# the example runs 400 iterations) for this many generic-NUTS
# transitions, then the multinomial sampler (L = 20, no warmup) for this
# many iterations; the cuts keep the phase near 60 s at the ~4.2 s per
# transition and ~0.3 s per iteration this phase measured on an H100.
ISO_DIM, ISO_CHAINS, ISO_M = 10000, 32, 9
ISO_NUTS_ITERS, ISO_MULTI_ITERS = 8, 30


def _assert_same(name, want, got, contract, int_cols=()):
    """Card run ``got`` against CPU run ``want`` (tensors): the integer
    columns equal, everything within ``contract``."""
    import numpy as np
    from walnuts_tpu_torch.utils.parity import assert_parity

    want, got = want.cpu().numpy(), got.cpu().numpy()
    if int_cols:
        np.testing.assert_array_equal(got[..., int_cols],
                                      want[..., int_cols], err_msg=name)
    assert_parity(want, got, contract, name)
    return float(np.abs(want - got).max())


def phase_stream(tw, rk, dev, scan_state, scan_s_per_it):
    """The streaming engine ``run_walnuts_streaming`` on the card (plain
    torch: the JAX streaming engine reaches no Pallas kernel).  (a)
    float64 funnel(11), C=64, m=5, R2P, hash draws, per-chain tuning, 20
    transitions on the card and on the CPU: integer columns equal,
    floats within the exact contract.  (b) the README width: funnel(101),
    4096 chains, m=10, R2P, float32, hash draws, ``STREAM_ITERS``
    transitions from 6b's adapted per-chain H, delta and positions."""
    import numpy as np
    import torch
    from walnuts_tpu_torch.utils.parity import EXACT

    int_cols = [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22]
    C, D = 64, 11
    rng = np.random.default_rng(1)
    q0 = 0.5 * rng.normal(size=(C, D))
    h, dl = np.linspace(0.25, 0.5, C), np.linspace(0.08, 0.3, C)
    kw = dict(target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=5),
              num_iter=20)
    t0 = time.perf_counter()
    out_g = tw.sampler.run_walnuts_streaming(5, q0, h, dl, device=dev, **kw)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    out_c = tw.sampler.run_walnuts_streaming(5, q0, h, dl, device="cpu",
                                             **kw)
    if out_g[0].device != dev:
        raise AssertionError("run_walnuts_streaming did not run on the card")
    err = max(_assert_same("7a samples", out_c[0], out_g[0], EXACT),
              _assert_same("7a diagnostics", out_c[1], out_g[1], EXACT,
                           int_cols),
              _assert_same("7a q_final", out_c[2], out_g[2], EXACT))
    _scan_check("7a", out_g[0], out_g[1], C, D, lead=0)
    log(f"phase 7a streaming f64 card == CPU: funnel(11) C=64 m=5 R2P hash, "
        f"per-chain H and delta, 20 transitions: integer columns equal, "
        f"max abs float diff {err:.3e} (rtol {EXACT['rtol']:g}, atol "
        f"{EXACT['atol']:g}); wall {t_gpu:.2f} s on the card")

    # (b) README width from 6b's adapted chains; the streaming path
    # launches no hand-written kernel
    C, D = SCAN_CHAINS, SCAN_DIM
    target = tw.targets.funnel(D)
    cfg = tw.WalnutsConfig(m=10, integrator="adapt_leapfrog_r2p")
    stats = {}
    rk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, d, qf = tw.sampler.run_walnuts_streaming(
        9, scan_state.q, scan_state.h, scan_state.delta, target=target,
        cfg=cfg, num_iter=STREAM_ITERS, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    codes = _scan_check("7b", s, d, C, D, lead=0)
    grads = int(d[..., 6].double().sum() + d[..., 7].double().sum())
    depth = d[..., 20].double()
    stop = {c: int((d[..., 19] == c).sum()) for c in sorted(codes)}
    # an orbit of depth d spans up to 2^(d-1) schedule rows: the
    # streaming engine needs the slowest chain's sum of them, the scan
    # engine the sum over transitions of the deepest chain's
    rows = torch.exp2(depth - 1.0)
    rows_chain = rows.sum(0)
    log(f"phase 7b streaming, README width: funnel({D}) C={C} m=10 R2P f32 "
        f"hash, {STREAM_ITERS} transitions per chain from 6b's adapted "
        f"chains in {wall:.2f} s over {stats['rounds']} rounds = "
        f"{wall / STREAM_ITERS:.3f} s per transition (6b's scan engine: "
        f"{scan_s_per_it:.3f} s per transition), "
        f"{wall / stats['rounds'] * 1e3:.2f} ms per round; {grads} grad "
        f"evals = {grads / wall:.1f} grad-evals/s; orbit depth mean "
        f"{float(depth.mean()):.2f}, worst {int(depth.max())}; stop codes "
        f"{stop}; sd(omega) {float(s[..., 0].double().std()):.3f}; "
        f"schedule rows (2^(depth-1) per transition) of the mean chain "
        f"{float(rows_chain.mean()):.0f}, of the slowest chain "
        f"{float(rows_chain.max()):.0f}, sum of each transition's deepest "
        f"{float(rows.amax(1).sum()):.0f}; round-kernel launches "
        f"{rk.launches}")
    stats = {}
    text, kernels = _profiled(lambda: tw.sampler.run_walnuts_streaming(
        10, qf, scan_state.h, scan_state.delta, target=target, cfg=cfg,
        num_iter=1, device=dev, stats=stats))
    log(f"phase 7b profile, 1 more transition per chain: {text}; "
        f"{stats['rounds']} rounds, {kernels / stats['rounds']:.0f} device "
        f"kernels per round")


def _iso_target(tw, dim):
    """Config 5's ``iso_std`` target (``examples/highdim_variants.py``):
    a standard normal in ``dim`` dimensions with the generated quantities
    ``[q_0 / sd_0, q_last / sd_last, sum (q / sd)^2]`` (sd = 1)."""
    import torch

    def logp_grad(q):
        return -0.5 * torch.sum(q * q, dim=-1), -q

    def generated(q):
        return torch.stack([q[..., 0], q[..., -1],
                            torch.sum(q * q, dim=-1)], dim=-1)

    return tw.Target(lambda q: logp_grad(q)[0], dim,
                     name=f"std_gauss_{dim}", generated=generated,
                     logp_grad=logp_grad)


def phase_iso(tw, rk, dev):
    """The isokinetic line on the card (plain torch: neither JAX path
    reaches a Pallas kernel).  (a) float64 std_gauss(5), C=16, m=5, on
    the card and on the CPU: ``run_generic_nuts`` with each kernel (10
    iterations, exact contract) and ``run_multinomial`` (isokinetic, L =
    12, 20 warmup + 10 iterations, adaptive contract).  (b) config 5's
    ``iso_std`` arm at full width: D = 10^4, 32 chains, m = 9, h_macro =
    1.4 D^-1/4, delta = 0.2, float32, ``IsokineticKernel``, from an exact
    stationary start; then ``run_multinomial`` (isokinetic, L = 20) on
    the same target and width."""
    import numpy as np
    import torch
    from walnuts_tpu_torch.diagnostics import ess_per_grad
    from walnuts_tpu_torch.utils import threefry
    from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT

    sp = tw.sampler
    C, D = 16, 5
    q0 = 0.8 * np.random.default_rng(2).normal(size=(C, D))
    t5 = tw.targets.std_gauss(D)
    for kname, kern in (("isokinetic", sp.IsokineticKernel()),
                        ("hmc", sp.HMCKernel())):
        kw = dict(target=t5, kernel=kern, h_macro=0.5, delta=0.1,
                  num_iter=10, m=5)
        s_g, d_g = sp.run_generic_nuts(11, q0, device=dev, **kw)
        s_c, d_c = sp.run_generic_nuts(11, q0, device="cpu", **kw)
        err = max(_assert_same(f"8a {kname} samples", s_c, s_g, EXACT),
                  _assert_same(f"8a {kname} diagnostics", d_c, d_g, EXACT,
                               [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]))
        log(f"phase 8a generic NUTS ({kname}) f64 card == CPU: "
            f"std_gauss(5) C=16 m=5, 10 iterations: integer columns "
            f"equal, max abs float diff {err:.3e} (rtol {EXACT['rtol']:g}, "
            f"atol {EXACT['atol']:g}); grad evals "
            f"{int(d_g[..., 7].sum())}")
    kw = dict(target=t5, kernel=sp.IsokineticKernel(),
              cfg=sp.MultinomialConfig(l_orbit=12), h0=0.6, delta0=0.2,
              num_iter=30, warmup_iter=20)
    out_g = sp.run_multinomial(17, q0, device=dev, **kw)
    out_c = sp.run_multinomial(17, q0, device="cpu", **kw)
    err = max(_assert_same("8a multinomial samples", out_c[0], out_g[0],
                           ADAPTIVE),
              _assert_same("8a multinomial diagnostics", out_c[1], out_g[1],
                           ADAPTIVE, [1, 2, 3, 4, 6, 9]),
              *(_assert_same("8a multinomial (h, delta)", a, b, ADAPTIVE)
                for a, b in zip(out_c[2], out_g[2])))
    log(f"phase 8a multinomial (isokinetic, WASPS) f64 card == CPU: "
        f"std_gauss(5) C=16 L=12, 20 warmup + 10 iterations: integer "
        f"columns equal, max abs float diff {err:.3e} (rtol "
        f"{ADAPTIVE['rtol']:g}, atol {ADAPTIVE['atol']:g}); adapted H "
        f"median {float(out_g[2][0].median()):.4f}")

    # (b) config 5's iso_std arm; the example's key and exact start
    C, D = ISO_CHAINS, ISO_DIM
    target = _iso_target(tw, D)
    key = threefry.PRNGKey(sum(map(ord, "iso_std")), dev)
    q0 = threefry.normal(key, (C, D), torch.float32)
    h = 1.4 * D ** -0.25
    rk.launches = 0
    runs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, d = sp.run_generic_nuts(threefry.fold_in(key, 1), q0, target=target,
                               kernel=sp.IsokineticKernel(), h_macro=h,
                               delta=0.2, num_iter=ISO_NUTS_ITERS, m=ISO_M,
                               device=dev)
    torch.cuda.synchronize()
    runs.append(("generic NUTS", ISO_NUTS_ITERS, time.perf_counter() - t0,
                 s, float(d[..., 7].double().sum()),
                 f"NUTtype counts {_counts(d[..., 6])}, orbit doublings "
                 f"mean {float(d[..., 0].double().mean()):.2f}, max "
                 f"{int(d[..., 0].max())}"))
    t0 = time.perf_counter()
    s, d, _ = sp.run_multinomial(
        threefry.fold_in(key, 2), q0, target=target,
        kernel=sp.IsokineticKernel(), cfg=sp.MultinomialConfig(l_orbit=20),
        h0=h, delta0=0.2, num_iter=ISO_MULTI_ITERS, warmup_iter=0,
        device=dev)
    torch.cuda.synchronize()
    runs.append(("multinomial L=20", ISO_MULTI_ITERS,
                 time.perf_counter() - t0, s, float(d[..., 9].double().sum()),
                 f"steps per orbit mean {float(d[..., 6].double().mean()):.2f}"
                 f", ESS fraction mean {float(d[..., 7].double().mean()):.4f}"))
    for name, n, wall, s, grads, extra in runs:
        draws = s[1:].double()
        if tuple(draws.shape) != (n, C, 3) or \
                not bool(torch.isfinite(draws).all()):
            raise AssertionError(f"8b {name}: bad draws {tuple(draws.shape)}")
        epg = ess_per_grad(draws, grads)
        log(f"phase 8b {name}, config 5 iso_std: D={D} C={C} f32 h_macro "
            f"{h:.5f} delta 0.2, {n} iterations in {wall:.2f} s = "
            f"{wall / n:.3f} s per iteration; {grads:.0f} grad evals = "
            f"{grads / wall:.1f} grad-evals/s; ESS per 1000 grads "
            f"(q0, q_last, radius) {[round(float(x), 3) for x in epg]}; "
            f"radius mean {float(draws[..., 2].mean()):.1f} against D = {D}; "
            f"{extra}; round-kernel launches {rk.launches}")


# Phase 9b runs the walnuts_d arm of examples/stock_watson.py at its
# full width: the proper model (D = 3T = 756), 256 chains, m = 10, H0 =
# 0.1, delta0 = 0.3, min_c = 3, fixed tuning, float32 with the bf16
# slab, round-capped invocations of SW_ROUNDS rounds.  The example's 500
# burn-in and 400 sampling transitions are cut to these, which keep the
# phase near 80 s at the ~0.1 s per transition this phase measured on an
# H100.
SW_CHAINS, SW_M, SW_H0, SW_DELTA0 = 256, 10, 0.1, 0.3
SW_BURNIN, SW_ITERS, SW_ROUNDS = 250, 250, 2500
SW_ADAM_STEPS, SW_ADAM_LR = 4000, 0.02


def _sw_find_mode(target, dev):
    """``examples/stock_watson.py:find_mode`` with ``torch.optim.Adam``:
    ``SW_ADAM_STEPS`` steps of ascent on the log density from zeros in
    float32.  Returns the point and its log density."""
    import torch

    q = torch.zeros(target.dim, device=dev, dtype=torch.float32,
                    requires_grad=True)
    opt = torch.optim.Adam([q], lr=SW_ADAM_LR)
    for _ in range(SW_ADAM_STEPS):
        _, g = target.logp_grad(q.detach())
        q.grad = -g
        opt.step()
    q = q.detach()
    return q, float(target.logp(q))


def _sw_stream(mk, seed, q0, h, dl, *, target, cfg, num_iter, ring_rows=None,
               limit_s=400):
    """One min_per_chain run as ``SW_ROUNDS``-round invocations that
    resume through ``mk_state`` (the example's ``_stream``).  Returns
    the final state and the number of invocations."""
    kw = dict(target=target, cfg=cfg, num_iter=num_iter,
              stop_mode="min_per_chain", rounds=SW_ROUNDS, diag_rows=8,
              ring_rows=ring_rows, device=q0.device)
    t0 = time.perf_counter()
    st, calls = None, 0
    while True:
        st = mk.run_walnuts_fused(seed, q0, h, dl, mk_state=st, **kw)[-1]
        calls += 1
        if int(st.it.min()) >= num_iter:
            return st, calls
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"Stock-Watson reached {int(st.it.min())} "
                                 f"of {num_iter} transitions in {limit_s} s")


def _contract_ratio(a, b, rtol, atol):
    """Largest ``|x - y| / (atol + rtol |y|)`` over the float banks."""
    import torch

    worst = 0.0
    for x, y in ((a.sf, b.sf), (a.vx, b.vx), (a.slab_q, b.slab_q),
                 (a.slab_v, b.slab_v), (a.samples, b.samples),
                 (a.diags, b.diags)):
        x, y = x.double(), y.double()
        fin = torch.isfinite(x) & torch.isfinite(y)
        if fin.any():
            r = (x[fin] - y[fin]).abs() / (atol + rtol * y[fin].abs())
            worst = max(worst, float(r.max()))
    return worst


def phase_sw(tw, mk, rk, dev):
    """Stock-Watson through the fused engine on the card.  (a) float64,
    the proper model at full D = 756, 32 chains from the mode plus
    0.5-sd jitter, 160 rounds under each of the example's three
    protocols, kernel against its plain twin: integer banks equal,
    floats within the exact contract where it holds, else the adaptive
    one.  (b) the example's walnuts_d arm at full width (``SW_*``), with
    a one-launch float32 check of the kernel against its twin at that
    shape, its speed, its kernel time per launch beside its bound, and
    its medians beside the committed example's bands.  Returns the
    kernels line's entry."""
    import torch
    from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT

    target = tw.targets.stock_watson(proper=True)
    D, T = target.dim, target.kernel_args["T"]
    t0 = time.perf_counter()
    mode, mode_lp = _sw_find_mode(target, dev)
    log(f"phase 9 Stock-Watson mode: Adam {SW_ADAM_STEPS} steps, lr "
        f"{SW_ADAM_LR}, from zeros, float32: logp {mode_lp:.2f} in "
        f"{time.perf_counter() - t0:.2f} s")

    # (a) the three protocols (examples/stock_watson.py:CONFIGS), f64
    # (m cut so that 160 rounds complete transitions and store draws)
    arms = (("walnuts_d", "adapt_leapfrog_d", 0.1, dict(min_c=3), 4, 4),
            ("walnuts_r2p", "adapt_leapfrog_r2p", 0.1, dict(min_c=3), 4, 4),
            ("nuts", "fixed_leapfrog", 0.002, {}, 6, 1))
    g = torch.Generator(device=dev).manual_seed(1)
    C = 32
    q0 = mode.double()[None] + 0.5 * torch.randn(
        C, D, generator=g, device=dev, dtype=torch.float64)
    it = rk.I_FIELDS.index("it")
    for tag, integ, h0, igr, m, unroll in arms:
        kw = dict(target=target, cfg=tw.WalnutsConfig(
            m=m, integrator=integ, igr=tw.IntegratorConfig(**igr)),
            num_iter=50, stop_mode="min_per_chain", rounds=160, diag_rows=8,
            micro_unroll=unroll, device=dev)
        h = torch.full((C,), h0, dtype=torch.float64, device=dev)
        dl = torch.full((C,), SW_DELTA0, dtype=torch.float64, device=dev)
        before = rk.launches
        a = rk.pack(mk.run_walnuts_fused(31, q0, h, dl, **kw)[-1])
        if rk.launches <= before:
            raise AssertionError("9a: the kernel path made no launch")
        b = rk.pack(mk.run_walnuts_fused_plain(31, q0, h, dl, **kw)[-1])
        torch.cuda.synchronize()
        try:
            err = _banks_compare(a, b, **EXACT)
            held = "EXACT holds"
        except AssertionError as e:
            if "integer" in str(e):
                raise
            err = _banks_compare(a, b, **ADAPTIVE)
            held = f"EXACT does not hold ({e}); ADAPTIVE holds"
        log(f"phase 9a f64 kernel vs plain, Stock-Watson {tag} ({integ}, "
            f"h {h0}, m={m}, micro_unroll={unroll}) D={D} C={C}, 160 "
            f"rounds: integer banks equal, max abs float diff {err:.3e}; "
            f"{held}; worst error over the EXACT bound "
            f"{_contract_ratio(a, b, **EXACT):.3g}, over the ADAPTIVE bound "
            f"{_contract_ratio(a, b, **ADAPTIVE):.3g}; draws "
            f"{int(a.si[it].sum())}")

    # (b) the walnuts_d arm at full width
    C = SW_CHAINS
    cfg = tw.WalnutsConfig(m=SW_M, integrator="adapt_leapfrog_d",
                           igr=tw.IntegratorConfig(min_c=3))
    g = torch.Generator(device=dev).manual_seed(0)
    q0 = mode[None] + 0.5 * torch.randn(C, D, generator=g, device=dev)
    h = torch.full((C,), SW_H0, device=dev)
    dl = torch.full((C,), SW_DELTA0, device=dev)

    # one launch of the kernel against its twin at this shape (f32)
    kw = dict(target=target, cfg=cfg, num_iter=SW_ITERS,
              stop_mode="min_per_chain", rounds=16, diag_rows=8, device=dev)
    launches = rk.launches
    a = rk.pack(mk.run_walnuts_fused(21, q0, h, dl, **kw)[-1])
    b = rk.pack(mk.run_walnuts_fused_plain(21, q0, h, dl, **kw)[-1])
    torch.cuda.synchronize()
    rk.launches = launches
    agree = (a.si == b.si).all(0)
    frac = float(agree.float().mean())
    if frac < 0.99:
        raise AssertionError(f"9b f32: integer state agrees on {frac:.4f} "
                             "of chains")
    cols = agree.nonzero().flatten()
    tol = dict(rtol=1e-4, atol=1e-3, slab_rtol=2.0 ** -7)
    f32_err = _banks_compare(
        rk.Banks(a.sf, a.si, a.vx, a.slab_q.float(), a.slab_v.float(),
                 a.samples, a.diags),
        rk.Banks(b.sf, b.si, b.vx, b.slab_q.float(), b.slab_v.float(),
                 b.samples, b.diags), chains=cols, **tol)
    log(f"phase 9b f32/bf16 kernel vs plain at the arm's shape (C={C}, "
        f"D={D}), 16 rounds: integer state equal on {frac:.4f} of chains; "
        f"on those, max abs float diff {f32_err:.3e} (rtol 1e-4, atol 1e-3, "
        f"slab rtol 2^-7)")

    rk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    burn, burn_calls = _sw_stream(mk, 22, q0, h, dl, target=target, cfg=cfg,
                                  num_iter=SW_BURNIN, ring_rows=8)
    torch.cuda.synchronize()
    t_burn = time.perf_counter() - t0
    burn_launches = rk.launches
    t0 = time.perf_counter()
    st, calls = _sw_stream(mk, 23, burn.qc, h, dl, target=target, cfg=cfg,
                           num_iter=SW_ITERS)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    launches = rk.launches
    if launches == 0:
        raise AssertionError("9b never launched the kernel")
    draws = st.samples
    if tuple(draws.shape) != (SW_ITERS, C, D) or \
            not bool(torch.isfinite(draws).all()):
        raise AssertionError(f"9b: bad draws {tuple(draws.shape)}")
    if int(st.it.min()) < SW_ITERS:
        raise AssertionError("9b: a chain is short of its quota")
    grads = (int(burn.grad_ct.to(torch.int64).sum())
             + int(st.grad_ct.to(torch.int64).sum()))
    wall = t_burn + t_draw
    depth = st.diags[..., 20].double()
    log(f"phase 9b Stock-Watson walnuts_d arm: proper model D={D} C={C} "
        f"m={SW_M} H0 {SW_H0} delta0 {SW_DELTA0} min_c=3 f32, fixed "
        f"tuning: {SW_BURNIN} burn-in transitions in {t_burn:.2f} s over "
        f"{burn_calls} calls ({burn_launches} launches), {SW_ITERS} draws "
        f"in {t_draw:.2f} s over {calls} calls ({launches - burn_launches} "
        f"launches): {grads} grad evals = {grads / wall:.1f} grad-evals/s, "
        f"{C * SW_ITERS / t_draw:.1f} draws/s; orbit depth of the last "
        f"diagnostics rows mean {float(depth.mean()):.2f}; kernel launches "
        f"{launches}; on {CARD}")

    # medians beside the committed example's bands (walnuts_d arm,
    # examples/out_stock_watson.json; each band is the mean over the
    # block's coordinates of a quantile)
    x = draws.double()
    bands = json.loads((HERE / "examples" / "out_stock_watson.json")
                       .read_text())["runs"]["walnuts_d"]["bands"]
    tau = x[..., 2 * T:3 * T].reshape(-1, T)
    taus = {t: float(tau[:, t].median()) for t in (0, T // 2, T - 1)}
    log(f"phase 9b medians over {SW_ITERS} draws x {C} chains (reported, "
        f"not a gate at this depth): sigma {float(x[..., 0].median()):.4f} "
        f"(example q10/q50/q90 {bands['sigma']['q10']:.4f} / "
        f"{bands['sigma']['q50']:.4f} / {bands['sigma']['q90']:.4f}); tau "
        f"at t = {list(taus)}: {[round(v, 4) for v in taus.values()]}, mean "
        f"over t of the median {float(tau.median(0).values.mean()):.4f} "
        f"(example band {bands['tau']['q10']:.4f} / "
        f"{bands['tau']['q50']:.4f} / {bands['tau']['q90']:.4f})")

    # kernel and twin time per launch at this shape, from the burnt-in
    # chains; these launches do not count
    st0 = mk.init_state(burn.qc, h, dl, target=target, cfg=cfg, warmup=None,
                        num_iter=SW_ITERS, diag_rows=8)
    spec = rk.RoundSpec(target=target, cfg=cfg, warmup=None,
                        stop_mode="min_per_chain", num_iter=SW_ITERS,
                        micro_unroll=1, seed=23)
    counted = rk.launches

    def timed(fn, periods):
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
        return e0.elapsed_time(e1) / periods, banks

    times = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "kernel", "plain"):
        fn = rk.run_rounds if name == "kernel" else rk.run_rounds_plain
        t, banks = timed(fn, 16 if name == "kernel" else 2)
        times[name].append(t)
        if name == "kernel":
            after = banks
    rk.launches = counted
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    bound = _bound(rk, rk.pack(st0), after, 16, None, SW_FLOPS_PER_COORD)
    log(f"phase 9b timing: Stock-Watson C={C} D={D} f32, 256 rounds: kernel "
        f"{ms:.4f} ms per 16-round launch "
        f"({[round(t, 4) for t in times['kernel']]}), plain {plain_ms:.3f} ms "
        f"({[round(t, 3) for t in times['plain']]}); bound {bound[0]:.4f} ms "
        f"({bound[1]}: {bound[2]}), kernel at {bound[0] / ms:.1%} of it; on "
        f"{CARD}")
    return dict(launches=launches, max_abs_err=f32_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])


def phase_modes(tw, rk, dev):
    """9c: the paper-pseudocode mode and the Monge integrators (plain
    torch: their JAX counterparts reach no Pallas kernel), float64 on
    the card and on the CPU at a small size, exact contract; the round
    kernel's launches over them are 0."""
    import numpy as np
    import torch
    from walnuts_tpu_torch.ops import monge
    from walnuts_tpu_torch.utils import threefry
    from walnuts_tpu_torch.utils.parity import EXACT

    rk.launches = 0
    C, D = 16, 6
    q0 = 0.5 * np.random.default_rng(3).normal(size=(C, D))
    kw = dict(target=tw.targets.funnel(D), inv_mass=1.0, macro_step=0.5,
              max_depth=5, max_error=0.2, iter_warmup=2, iter_sample=4)
    t0 = time.perf_counter()
    s_g = tw.sampler.walnuts_pseudo(5, q0, device=dev, **kw)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    s_c = tw.sampler.walnuts_pseudo(5, q0, device="cpu", **kw)
    if s_g.device != dev:
        raise AssertionError("walnuts_pseudo did not run on the card")
    err = _assert_same("9c pseudocode draws", s_c, s_g, EXACT)
    res = [tw.sampler.walnuts_step_pseudo(
        threefry.PRNGKey(6, d), torch.from_numpy(q0).to(d), **{
            k: v for k, v in kw.items() if not k.startswith("iter")})
        for d in ("cpu", dev)]
    err = max(err, _assert_same("9c pseudocode step q", res[0].q, res[1].q,
                                EXACT))
    for f in ("n_grad", "depth_stopped"):
        if not torch.equal(getattr(res[0], f), getattr(res[1], f).cpu()):
            raise AssertionError(f"9c pseudocode step: {f} differs")
    log(f"phase 9c pseudocode mode f64 card == CPU: funnel({D}) C={C} macro "
        f"step 0.5, max depth 5, 2 + 4 transitions and one step: n_grad and "
        f"depth_stopped equal, max abs float diff {err:.3e} (rtol "
        f"{EXACT['rtol']:g}, atol {EXACT['atol']:g}); grad evals of the "
        f"step {int(res[1].n_grad.sum())}; wall {t_gpu:.2f} s on the card")

    target = tw.targets.corr_gauss(0.95)
    rng = np.random.default_rng(4)
    q, p = 0.5 * rng.normal(size=(C, 2)), rng.normal(size=(C, 2))
    h = np.linspace(0.05, 0.2, C)
    out = {}
    for d in ("cpu", dev):
        qd, pd, hd = (torch.from_numpy(x).to(d) for x in (q, p, h))
        s0 = monge.monge_init(target, qd, pd)
        s1, lj = monge.monge_int(target, s0, hd, 8)
        eps = monge.monge_eps_int(target, qd, pd, key=threefry.PRNGKey(7, d),
                                  h=0.1, nstep=4)
        ode = monge.monge_int_adapt(target, qd, pd, 0.5)
        out[str(d)] = [x.double() for x in (*s1, lj, *eps, *ode)]
    errs = [_assert_same(f"9c monge {i}", a, b, EXACT)
            for i, (a, b) in enumerate(zip(out["cpu"], out[str(dev)]))]
    log(f"phase 9c Monge integrators f64 card == CPU: corr_gauss(0.95) C={C}: "
        f"monge_int (8 steps, log-Jacobian), monge_eps_int (4 steps), "
        f"monge_int_adapt (t = 0.5, rtol/atol 1e-10): max abs diff "
        f"{max(errs):.3e} (rtol {EXACT['rtol']:g}, atol {EXACT['atol']:g}); "
        f"round-kernel launches over 9c {rk.launches}")


def _counts(x):
    vals, counts = x.unique(return_counts=True)
    return {int(v): int(c) for v, c in zip(vals.tolist(), counts.tolist())}


if __name__ == "__main__":
    main()
