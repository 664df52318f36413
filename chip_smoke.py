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
Monge integrators on the card against the CPU; 9d runs the port's
example harness (``walnuts_tpu_torch.examples.stock_watson``, whose
mode search and streams 9 and 9b use too) for its R2P (m = 10) and
NUTS (m = 12) arms at 256 chains, each with a one-launch check of the
kernel against its twin, its speed, kernel time beside its bound and
its split-Rhat and bands beside the JAX example's, then times the copy
of the harness's largest ring that each of its engine calls makes.  Phase 10 starts two
gloo ranks on the one card (``walnuts_tpu_torch.parallel.run_ranks``,
with the rank functions below): 10a holds the float64 kernel over the
ranks against one process, 10b runs the main path at full width over
the two ranks and requires phase 4's launches, grads, draws and ESS bit
for bit, 10c holds the native C++ engine (the CPU oracle) against the
fused engine on the card, and 10d holds what the kernel does not fuse
against the CPU: a summary of the user's own (``bench.py``'s, as a
function), which the kernel stages for torch to map, and ``smile``, a
target without a fused gradient.  10e runs the scan engine on a (2, 2)
``(chains, dim)`` mesh of four gloo ranks on the card (every sum over D
all-reduced over a rank's dim group): (a) float64 funnel(11), split 6 +
5, against one process on the card, under EXACT without adaptation and
ADAPTIVE with pooled warmup; (b) 6b's run at the README width
(funnel(101) split 51 + 50) for a few transitions, with its s per
transition beside 6b's, its dim-group collectives per transition and
their ms, its stop codes and depths.  10f runs the streaming engine
(both draws), generic NUTS and the multinomial sampler with their
chains over two ranks against one process on the card, under EXACT.
10g runs them on the whole (2, 2) mesh (each rank its chains and its
columns), with the implicit midpoint's Newton mode: (a) float64 against
one process on the card, under EXACT without adaptation and ADAPTIVE
for the multinomial sampler's warmup; (b) one generic-NUTS iteration of
8b's ``iso_std`` arm at full width (D = 10^4 split 5000 + 5000), with
its wall and dim-group collectives beside 8b's s per iteration.
Phase 11 runs targets without a fused gradient through
the kernel's external-gradient instantiation (a period is ``16 *
micro_unroll + 1`` segment launches with the target's torch
``logp_grad`` between them, captured once as a CUDA graph and
replayed): 11a holds the graphed periods bit for bit to the same
segments run eagerly, then against the plain twin in float64, for
every analytic target without a fused gradient, a user's ``logp`` and
Stock-Watson at T = 300; 11b runs the main path's timed phase with
funnel(101) handed over as a user's target, with its speed, the graphed
and eager ms per period, and the split of a period into micro-step
segments, round-boundary segments and torch's kernels.  Phase 12 runs
the port's gaussian-transient harness (``walnuts_tpu_torch.examples.
gaussian_transient``, the scan engine) for its d = 2048 row at the JAX
artifact's stamp (1024 chains, float32, 31 iterations, three arms)
behind the harness's own gate, with each arm's iterations to 95% beside
the JAX artifact's, then the same row in float64 (50 chains, 4
iterations) on the card against the CPU.  Phase 13 runs the port's last
two scan-engine harnesses: (a) ``walnuts_tpu_torch.examples.
gaussian_ess``'s program at d = 1024 (64 chains) for its three arms,
with ESS per 1000 gradient evaluations beside the JAX artifact's row;
(b) ``walnuts_tpu_torch.examples.highdim_variants``' ``im_std`` arm (the
implicit midpoint, D = 10^4, 32 chains) for a few transitions behind
the harness's z gate, with the fixed-point loop's host syncs; (c) its
``im_illcond`` and ``iso_illcond`` arms at D = 16 in float64 on the
card against the CPU.  Phase 14 holds the round kernel to the posterior
at the JAX package's fused-engine tests' configurations
(``tests/test_megakernel.py``, ``tests/test_float32.py``: small D,
float64, ``micro_unroll`` 1 against 4, float32 against float64, in-loop
and pooled warmup) behind their own gates, with the scan engine's side of
two comparisons run on the host CPU meanwhile.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (the build goes to
``walnuts_tpu_torch/build/``); without them it fails and prints no
result.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the line before it lists each kernel with its launches on the
main path, its largest error against the plain twin, both times, the
least time the card could take for a launch's work (``bound_ms``) and
the instantiation's registers and resident warps per SM; the
external-gradient entry's times are per 16-round period.  The
line after the device line is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.
"""

import functools
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

    attrs, ext_attrs = phase_build(_build, rk)
    phase_f64(tw, mk, rk, dev)
    max_abs_err = phase_f32(tw, mk, rk, dev)
    warm, launches, main_run = phase_main(tw, mk, rk, dev)
    ms, plain_ms, bound_ms, bound_by = phase_timing(tw, mk, rk, dev, warm)
    scan_state, scan_s_per_it = phase_scan(tw, rk, dev)
    phase_stream(tw, rk, dev, scan_state, scan_s_per_it)
    iso_s_per_it = phase_iso(tw, rk, dev)
    sw, mode = phase_sw(tw, mk, rk, dev)
    phase_sw_arms(tw, mk, rk, dev, mode)
    phase_modes(tw, rk, dev)
    phase_ranks_exact(tw, mk, rk, dev)
    phase_ranks_main(tw, mk, rk, dev, main_run)
    phase_native(tw, mk, rk, dev)
    phase_card_route(tw, mk, rk, dev)
    phase_dim_split(tw, rk, dev, scan_s_per_it, iso_s_per_it)
    ext = phase_external(tw, mk, rk, dev, warm, main_run, ext_attrs)
    phase_examples(rk, dev)
    stats_scans = start_stats_scans()
    phase_last_examples(rk, dev)
    phase_stats(rk, dev, stats_scans)
    kernel = {"route": "cuda",
              "source": "walnuts_tpu_torch/csrc/round_kernel.cu",
              "replaces": "walnuts_tpu/sampler/pallas_megakernel.py:158",
              "library_ms": None}
    log(json.dumps({"kernels": [
        dict(kernel, name="walnuts_round_kernel", launches=launches,
             max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, regs=attrs["regs"],
             warps_per_sm=attrs["warps_per_sm"]),
        dict(kernel, name="walnuts_round_kernel[stock_watson]", **sw),
        dict(kernel, name="walnuts_round_kernel[external_grad]", **ext)]}))
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
    shapes.append(("stock_watson", "2", 756))  # DPL 6 over 4 warps
    shapes.append(("external", "3", 101))  # DPL 0 at every D
    micro = {}  # round_kernel_micro<T>, the external micro-step segments
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '_Z18round_kernel_microI"
                      r"(f|d)E", line)
        if m:
            used = next(x for x in lines[i + 1:] if "Used" in x)
            micro[m.group(1)] = used.split(":")[1].strip()
    for prec, dtype in (("f", torch.float32), ("d", torch.float64)):
        for tgt, tid, D in shapes:
            a = rk.kernel_attributes(dtype, tgt, D)
            dpl = a["dpl"]
            log(f"  round_kernel<{dtype}, {tgt}, DPL={dpl}, "
                f"WPC={a['warps_per_chain']}>: ptxas "
                f"{ptxas.get((prec, tid, str(dpl)), 'not found')} | "
                f"runtime {a['regs']} registers, {a['local_bytes']} "
                f"local bytes, {a['threads_per_block']} threads/block, "
                f"{a['warps_per_sm']} warps/SM")
        a = rk.kernel_attributes(dtype, "external", 101)
        log(f"  round_kernel_micro<{dtype}> (external micro-step "
            f"segments): ptxas {micro.get(prec, 'not found')} | runtime "
            f"{a['micro_regs']} registers, {a['micro_warps_per_sm']} "
            f"warps/SM")
    # Stock-Watson: one chain per block, the example's 256 chains
    # resident in one wave, nothing in local memory
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        a = rk.kernel_attributes(dtype, "stock_watson", 756)
        wave = a["blocks_per_sm"] * sms * a["threads_per_block"] // (
            32 * a["warps_per_chain"])
        log(f"  stock_watson {dtype}: {wave} chains resident in one wave on "
            f"{sms} SMs ({SW_CHAINS} run), {a['local_bytes']} local bytes")
        if wave < SW_CHAINS or a["local_bytes"]:
            raise AssertionError("phase 1: the Stock-Watson instantiation "
                                 "does not hold its chains in one wave "
                                 "without local memory")
    main = rk.kernel_attributes(torch.float32, "funnel", 101)
    log(f"  main path (float32 funnel, D=101): {main}")
    ext = rk.kernel_attributes(torch.float32, "external", 101)
    log(f"  external-gradient segments (float32, D=101): {ext}")
    return main, ext


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
          q_seed=1234, h=0.4, delta=0.15, diag_rows=8, eager=False):
    """Run the same capped invocation (of funnel(D) unless ``target`` is
    given) through the kernel (one launch per period, or the
    external-gradient segments) and the plain twin; return both final
    bank sets.  ``eager``: run the external-gradient segments once more
    eagerly (``round_kernel._launch(graph=False)``; not counted) and
    require every bank bit for bit equal to the graphed run's."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(q_seed)
    q0 = (0.3 * torch.randn(C, D, generator=g, dtype=torch.float64)).to(
        device=dev, dtype=dtype)
    kw = dict(target=target or tw.targets.funnel(D, generated=generated),
              cfg=tw.WalnutsConfig(m=m), num_iter=num_iter,
              stop_mode=stop_mode, warmup=warmup, rounds=rounds,
              ring_rows=ring_rows, diag_rows=diag_rows,
              micro_unroll=micro_unroll)
    h = torch.full((C,), h, dtype=dtype, device=dev)
    dl = torch.full((C,), delta, dtype=dtype, device=dev)
    before = rk.launches + rk.segment_launches
    st_k = mk.run_walnuts_fused(seed, q0, h, dl, **kw)[-1]
    torch.cuda.synchronize()
    if rk.launches + rk.segment_launches <= before:
        raise AssertionError("the kernel path made no launch")
    if eager:
        counted, launch = rk.segment_launches, rk._launch
        rk._launch = functools.partial(launch, graph=False)
        try:
            st_e = mk.run_walnuts_fused(seed, q0, h, dl, **kw)[-1]
        finally:
            rk._launch, rk.segment_launches = launch, counted
        torch.cuda.synchronize()
        _bits_equal(rk.pack(st_k), rk.pack(st_e))
    st_p = mk.run_walnuts_fused_plain(seed, q0, h, dl, **kw)[-1]
    torch.cuda.synchronize()
    return rk.pack(st_k), rk.pack(st_p)


def _bits_equal(a, b):
    """Raises unless two bank sets are equal bit for bit, NaNs included."""
    import torch

    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    for name, x, y in zip(a._fields, a, b):
        t = bits[x.element_size()]
        if not torch.equal(x.view(t), y.view(t)):
            raise AssertionError(f"bank {name}: graphed and eager segments "
                                 "differ")


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
    for name, kw, tol in cases:
        a, b = _pair(tw, mk, rk, dev, D=101, m=8, dtype=torch.float32,
                     rounds=16, **kw)
        worst = max(worst, _f32_compare(
            rk, "phase 3 f32/bf16 kernel vs plain: " + name, a, b, tol))
    return worst


def _f32_compare(rk, name, a, b, tol):
    """Phase 3's test of one float32 period, kernel banks ``a`` against
    the twin's ``b``: integer state equal on >= 99% of chains, floats on
    those chains within ``tol``.  Logs and returns the largest float
    difference."""
    import torch

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
    it = rk.I_FIELDS.index("it")
    log(f"{name}, 16 rounds: integer state equal on {frac:.4f} of chains; "
        f"on those, max abs float diff {err:.3e} ({tol_s}), slab max abs "
        f"diff {slab:.3e}; draws {int(a.si[it].sum())}")
    return err


MAIN_C, MAIN_D, MAIN_M, MAIN_WARMUP, MAIN_ITERS = 8192, 101, 8, 700, 300


def run_main_path(tw, mk, rk, dev, mesh=None):
    """The benchmark's main path through the public entry point, on this
    rank's block of the 8192 chains under ``mesh`` (all of them without
    one): pooled warmup in 2500-round invocations, then the timed
    ``min_per_chain`` draws.  The counts are reset just before it and
    read just after.  Returns what phases 4 and 10b report; ``grads``
    and ``draws`` are this rank's."""
    import torch
    from walnuts_tpu_torch.parallel import reduce_int, shard_chains

    C, D, M, WARMUP, ITERS = (MAIN_C, MAIN_D, MAIN_M, MAIN_WARMUP,
                              MAIN_ITERS)
    g = torch.Generator(device=dev).manual_seed(0)
    q0 = 0.3 * torch.randn(C, D, generator=g, device=dev,
                           dtype=torch.float32)
    h0 = torch.full((C,), 0.3, device=dev)
    d0 = torch.full((C,), 0.3, device=dev)
    if mesh is not None:
        q0, h0, d0 = shard_chains((q0, h0, d0), mesh)
    cfg = tw.WalnutsConfig(m=M)
    rk.launches = 0

    # warmup: round-capped invocations that resume through mk_state
    wu = tw.WarmupConfig(warmup_iter=WARMUP, pooled=True)
    kw = dict(target=tw.targets.funnel(D), cfg=cfg, num_iter=WARMUP,
              warmup=wu, ring_rows=8, rounds=2500, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    st, calls = None, 0
    while True:
        out = mk.run_walnuts_fused(11, q0, h0, d0, mk_state=st, **kw)
        st = out[-1]
        calls += 1
        done = reduce_int(st.it.min(), mesh, "min")
        if calls % 25 == 0:
            log(f"  warmup: {done}/{WARMUP} after "
                f"{time.perf_counter() - t0:.1f} s")
        if done >= WARMUP:
            break
        if time.perf_counter() - t0 > 600:
            raise AssertionError(f"warmup reached {done} of {WARMUP} "
                                 "transitions in 600 s")
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm = st
    warm_launches = rk.launches

    # timed sampling: min_per_chain, micro_unroll=4, (omega, sum x^2)
    target = tw.targets.funnel(D, generated=tw.targets.omega_sumsq)
    kw = dict(target=target, cfg=cfg, num_iter=ITERS,
              stop_mode="min_per_chain", diag_rows=8, micro_unroll=4,
              rounds=12000, device=dev, mesh=mesh)
    warm_calls = calls
    t0 = time.perf_counter()
    st, calls = None, 0
    while True:
        out = mk.run_walnuts_fused(13, warm.qc, warm.h_cur, warm.delta_cur,
                                   mk_state=st, **kw)
        st = out[-1]
        calls += 1
        done = reduce_int(st.it.min(), mesh, "min")
        if done >= ITERS:
            break
        if time.perf_counter() - t0 > 400:
            raise AssertionError(f"timed phase reached {done} of {ITERS} "
                                 "draws in 400 s")
    torch.cuda.synchronize()
    t_timed = time.perf_counter() - t0
    return dict(warm=warm, t_warm=t_warm, warm_calls=warm_calls,
                warm_launches=warm_launches, t_timed=t_timed, calls=calls,
                launches=rk.launches,
                grads=int(st.grad_ct.to(torch.int64).sum()),
                draws=st.samples, final=st)


def phase_main(tw, mk, rk, dev):
    """Phase 4: the main path in one process."""
    import torch
    from walnuts_tpu_torch.diagnostics import ess

    r = run_main_path(tw, mk, rk, dev)
    C, M, WARMUP, ITERS = MAIN_C, MAIN_M, MAIN_WARMUP, MAIN_ITERS
    launches, warm = r["launches"], r["warm"]
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    grads, t_timed = r["grads"], r["t_timed"]
    draws = r["draws"].double()                       # [300, C, 2]
    if tuple(draws.shape) != (ITERS, C, 2) or \
            not bool(torch.isfinite(draws).all()):
        raise AssertionError(f"bad draws: shape {tuple(draws.shape)}")
    ess_vals = ess(draws)
    min_ess_s = float(ess_vals.min()) / t_timed
    sd_err = abs(float(draws[..., 0].std()) - 3.0)
    log(f"phase 4 main path: funnel(101) C={C} m={M} f32: warmup "
        f"{WARMUP} pooled in {r['t_warm']:.2f} s over {r['warm_calls']} "
        f"calls of 2500 rounds (adapted H median "
        f"{float(warm.h_cur.median()):.4f}, delta median "
        f"{float(warm.delta_cur.median()):.4f}); timed {ITERS} draws in "
        f"{t_timed:.2f} s over {r['calls']} calls of 12000 rounds: {grads} "
        f"grad evals = {grads / t_timed:.1f} grad-evals/s, ESS (omega, sum "
        f"x^2) = {[round(float(e), 1) for e in ess_vals]}, min-ESS/s "
        f"{min_ess_s:.2f}, |sd(omega) - 3| = {sd_err:.4f}, kernel launches "
        f"{launches} ({r['warm_launches']} warmup, "
        f"{launches - r['warm_launches']} timed); on {CARD}")
    if not sd_err < 0.3:
        raise AssertionError(f"|sd(omega) - 3| = {sd_err:.4f} >= 0.3")
    return warm, launches, dict(grads=grads, ess=ess_vals,
                                draws=r["draws"], launches=launches,
                                t_timed=t_timed, t_warm=r["t_warm"])


def _bound(rk, b0, b1, periods, warmup, flops_per_coord=FLOPS_PER_COORD,
           extra_bytes=0):
    """Least ms a launch could take on an H100 SXM for the work between
    bank sets ``b0`` and ``b1`` (``periods`` launches apart): the larger
    of two times.  One is the bytes over the HBM rate: the state that is
    live across a launch, read once and written once (the scalar rows,
    the P2 estimators' rows only under ``warmup``, the vectors at their
    D columns, the slabs), plus the ring rows the draws write, plus
    ``extra_bytes`` per launch.  The two pending slots' staging rows are
    empty when a launch starts and when it ends, so they are left out.
    The other is the gradient evaluations' float operations over the
    float32 rate.  Returns ``(ms, "bytes" or "operations", detail)``."""
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
    nbytes = (2 * state + draws * (b0.samples.shape[2] + 24) * isz
              + extra_bytes)
    byte_ms = nbytes / HBM_BYTES_S * 1e3
    op_ms = grads * D * flops_per_coord / F32_FLOP_S * 1e3
    gflop = grads * D * flops_per_coord / 1e9
    detail = (f"{nbytes / 1e6:.1f} MB moved ({2 * state / 1e6:.1f} MB of "
              f"state in and out"
              + (f", {extra_bytes / 1e6:.1f} MB of gradient exchange"
                 if extra_bytes else "")
              + f") = {byte_ms:.4f} ms at 3.35 TB/s; "
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
# sampling transitions: over 10 of warmup, so that delta adaptation (from
# iteration 11) runs, and few enough to keep the phase near 40 s.
SCAN_WARMUP, SCAN_ITERS = 12, 4
SCAN_CHAINS, SCAN_DIM = 4096, 101     # the Quick start's C and funnel(D)
STOP_CODES = (0, 4, -4, 5, 999)
# The integer-valued diagnostics columns of the scan engine (24 columns)
# and of generic NUTS (12), which card-vs-CPU checks hold equal.
SCAN_INT_COLS = [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22]
GENERIC_INT_COLS = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]


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

    int_cols = SCAN_INT_COLS
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
# near 20 s at the ~4 s per transition this phase measured on an H100).
STREAM_ITERS = 5
# Phase 8b runs config 5's iso_std arm (D = 10^4, 32 chains, m = 9;
# the example runs 400 iterations) for this many generic-NUTS
# transitions, then the multinomial sampler (L = 20, no warmup) for this
# many iterations; the cuts keep the phase near 30 s at the ~4.2 s per
# transition and ~0.3 s per iteration this phase measured on an H100.
ISO_DIM, ISO_CHAINS, ISO_M = 10000, 32, 9
ISO_NUTS_ITERS, ISO_MULTI_ITERS = 4, 15


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

    int_cols = SCAN_INT_COLS
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


def phase_iso(tw, rk, dev):
    """The isokinetic line on the card (plain torch: neither JAX path
    reaches a Pallas kernel).  (a) float64 std_gauss(5), C=16, m=5, on
    the card and on the CPU: ``run_generic_nuts`` with each kernel (10
    iterations, exact contract) and ``run_multinomial`` (isokinetic, L =
    12, 20 warmup + 10 iterations, adaptive contract).  (b) config 5's
    ``iso_std`` arm at full width: D = 10^4, 32 chains, m = 9, h_macro =
    1.4 D^-1/4, delta = 0.2, float32, ``IsokineticKernel``, from an exact
    stationary start; then ``run_multinomial`` (isokinetic, L = 20) on
    the same target and width.  Returns (b)'s generic-NUTS s per
    iteration."""
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
                               GENERIC_INT_COLS))
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

    # (b) config 5's iso_std arm; the example's target, key and exact start
    from walnuts_tpu_torch.examples import highdim_variants as hv
    C, D = ISO_CHAINS, ISO_DIM
    target = hv.make_target("iso_std", D, torch.float32)
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
    return runs[0][2] / runs[0][1]


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
# Phase 9d runs the port's harness (walnuts_tpu_torch.examples.
# stock_watson.run_arm) for these arms at 9b's width, their burn-in and
# draws cut to these (the full run is the harness's own)
SW_ARMS = ("walnuts_r2p", "nuts")
SW_ARM_BURNIN = SW_ARM_ITERS = 100
# the ring of the harness's longest sample phase (the R2P arm's 6000
# draws of 128 chains), whose copy per call 9d times
SW_RING = (6000, 128)
# A device sleep of ~25 ms at the H100's clocks, ahead of a timed run of
# launches that each take less time on the card than on the host
SLEEP_CYCLES = 50_000_000


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


# The float32 rows that carry differences and exponentials of the
# Hamiltonian: the energy errors and the multinomial weight sums
# exp(H0 - H).  From the harness's start (the mode plus 0.5-sd jitter)
# some chains begin with |H| up to ~1e10 and lose hundreds of units of
# it within a launch (the float64 weight sums reach ~1e211), so a
# last-bit difference of H between two summation orders moves these
# rows by far more than 9b's rtol; 9d holds them in float64 instead.
SW_ENERGY_ROWS = ("dht", "dha", "w_new_sum", "w_old_sum")


def _sw_twin_check(mk, rk, target, cfg, q0, h, dl, seed, num_iter,
                   skip_rows=()):
    """One 16-round launch of the float32 kernel against its twin from
    ``q0`` at the arm's shape: the share of chains whose integer state
    is equal (at least 0.99, else this raises) and, on those, the
    largest float difference within rtol 1e-4, atol 1e-3 and one bf16
    ulp for the slabs, outside the scalar rows named in ``skip_rows``.
    Those rows' largest relative difference is returned too (None
    without them).  These launches do not count."""
    import torch

    kw = dict(target=target, cfg=cfg, num_iter=num_iter,
              stop_mode="min_per_chain", rounds=16, diag_rows=8,
              device=q0.device)
    launches = rk.launches
    a = rk.pack(mk.run_walnuts_fused(seed, q0, h, dl, **kw)[-1])
    b = rk.pack(mk.run_walnuts_fused_plain(seed, q0, h, dl, **kw)[-1])
    torch.cuda.synchronize()
    rk.launches = launches
    agree = (a.si == b.si).all(0)
    frac = float(agree.float().mean())
    if frac < 0.99:
        raise AssertionError(f"f32 Stock-Watson: integer state agrees on "
                             f"{frac:.4f} of chains")
    cols = agree.nonzero().flatten()
    sf_a, rel = a.sf, None
    if skip_rows:
        rows = [rk.F_FIELDS.index(f) for f in skip_rows]
        x = a.sf[rows][:, cols].double()
        y = b.sf[rows][:, cols].double()
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)):
            raise AssertionError(f"f32 Stock-Watson: non-finite entries of "
                                 f"{skip_rows} differ")
        fin = torch.isfinite(y) & (y != 0)
        rel = float(((x - y).abs()[fin] / y.abs()[fin]).max()) \
            if fin.any() else 0.0
        sf_a = a.sf.clone()
        sf_a[rows] = b.sf[rows]
    err = _banks_compare(
        rk.Banks(sf_a, a.si, a.vx, a.slab_q.float(), a.slab_v.float(),
                 a.samples, a.diags),
        rk.Banks(b.sf, b.si, b.vx, b.slab_q.float(), b.slab_v.float(),
                 b.samples, b.diags), chains=cols, rtol=1e-4, atol=1e-3,
        slab_rtol=2.0 ** -7)
    return frac, err, rel


def _sw_timing(mk, rk, target, cfg, qc, h, dl, seed, num_iter, plain=True):
    """Kernel (and, if ``plain``, twin) ms per 16-round launch from the
    chains ``qc``, best of two runs of 16 kernel launches (2 twin
    periods), each queued behind a device sleep: at ~0.05 ms a kernel
    takes less than the host's ``run_rounds`` call, and the events would
    time the host.  Returns ``(ms, plain_ms, kernel runs, twin runs,
    bound)`` with ``_bound`` over the kernel's launches; these launches
    do not count."""
    import torch

    st0 = mk.init_state(qc, h, dl, target=target, cfg=cfg, warmup=None,
                        num_iter=num_iter, diag_rows=8)
    spec = rk.RoundSpec(target=target, cfg=cfg, warmup=None,
                        stop_mode="min_per_chain", num_iter=num_iter,
                        micro_unroll=1, seed=seed)
    counted = rk.launches

    def timed(fn, periods):
        banks = rk.pack(st0)
        fn(banks, 0, spec)  # warm the path
        banks = rk.pack(st0)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        for i in range(periods):
            fn(banks, i * mk.FLUSH_EVERY, spec)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / periods, banks

    times = {"kernel": [], "plain": []}
    order = ("kernel", "plain", "kernel", "plain") if plain else ("kernel",
                                                                  "kernel")
    for name in order:
        fn = rk.run_rounds if name == "kernel" else rk.run_rounds_plain
        t, banks = timed(fn, 16 if name == "kernel" else 2)
        times[name].append(t)
        if name == "kernel":
            after = banks
    rk.launches = counted
    bound = _bound(rk, rk.pack(st0), after, 16, None, SW_FLOPS_PER_COORD)
    return (min(times["kernel"]), min(times["plain"], default=None),
            times["kernel"], times["plain"], bound)


def phase_sw(tw, mk, rk, dev):
    """Stock-Watson through the fused engine on the card.  (a) float64,
    the proper model at full D = 756, 32 chains from the mode plus
    0.5-sd jitter, 160 rounds under each of the example's three
    protocols, kernel against its plain twin: integer banks equal,
    floats within the exact contract where it holds, else the adaptive
    one.  (b) the example's walnuts_d arm at full width (``SW_*``), with
    a one-launch float32 check of the kernel against its twin at that
    shape, its speed, its kernel time per launch beside its bound, and
    its medians beside the committed example's bands; its streams are
    the port's harness's (``walnuts_tpu_torch.examples.stock_watson``).
    Returns the kernels line's entry and the mode."""
    import torch
    from walnuts_tpu_torch.examples import stock_watson as swx
    from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT

    target = tw.targets.stock_watson(proper=True)
    D, T = target.dim, target.kernel_args["T"]
    t0 = time.perf_counter()
    mode, mode_lp = swx.find_mode(target, steps=SW_ADAM_STEPS, lr=SW_ADAM_LR,
                                  device=dev)
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
    frac, f32_err, _ = _sw_twin_check(mk, rk, target, cfg, q0, h, dl, 21,
                                      SW_ITERS)
    log(f"phase 9b f32/bf16 kernel vs plain at the arm's shape (C={C}, "
        f"D={D}), 16 rounds: integer state equal on {frac:.4f} of chains; "
        f"on those, max abs float diff {f32_err:.3e} (rtol 1e-4, atol 1e-3, "
        f"slab rtol 2^-7)")

    rk.launches = 0
    kw = dict(target=target, cfg=cfg, rounds=SW_ROUNDS, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    burn, burn_calls = swx.stream(22, q0, h, dl, num_iter=SW_BURNIN,
                                  ring_rows=8, tag="9b burn-in", **kw)
    torch.cuda.synchronize()
    t_burn = time.perf_counter() - t0
    burn_launches = rk.launches
    t0 = time.perf_counter()
    st, calls = swx.stream(23, burn.qc, h, dl, num_iter=SW_ITERS,
                           tag="9b draws", **kw)
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
    bands = _example_runs()["walnuts_d"]["bands"]
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
    # chains
    ms, plain_ms, k_runs, p_runs, bound = _sw_timing(
        mk, rk, target, cfg, burn.qc, h, dl, 23, SW_ITERS)
    log(f"phase 9b timing: Stock-Watson C={C} D={D} f32, 256 rounds: kernel "
        f"{ms:.4f} ms per 16-round launch ({[round(t, 4) for t in k_runs]}), "
        f"plain {plain_ms:.3f} ms ({[round(t, 3) for t in p_runs]}); bound "
        f"{bound[0]:.4f} ms ({bound[1]}: {bound[2]}), kernel at "
        f"{bound[0] / ms:.1%} of it; on {CARD}")
    return dict(launches=launches, max_abs_err=f32_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1]), mode


def _example_runs():
    """The committed JAX example's arms (examples/out_stock_watson.json)."""
    return json.loads((HERE / "examples" / "out_stock_watson.json")
                      .read_text())["runs"]


def phase_sw_arms(tw, mk, rk, dev, mode):
    """9d: the port's Stock-Watson harness (``walnuts_tpu_torch.
    examples.stock_watson.run_arm``) for the ``SW_ARMS`` at 9b's width:
    the proper model, D = 756, ``SW_CHAINS`` chains, float32, fixed
    tuning from the mode plus 0.5 sd, each arm's own m (R2P 10, NUTS
    12), ``SW_ARM_BURNIN`` burn-in transitions and ``SW_ARM_ITERS``
    draws.  For each arm: the float64 kernel against its twin at the
    arm's shape under the exact contract, one float32 launch against the
    twin (``_sw_twin_check``, the ``SW_ENERGY_ROWS`` reported), the run (launches, finite draws, every chain at
    its quota; wall, grad-evals/s, draws/s), kernel ms per launch
    beside its bound, and the harness's split-Rhat and bands beside the
    same arm's in examples/out_stock_watson.json (reported, not gated,
    at this depth).  Then the copy of the harness's largest ring
    (``SW_RING``) that each of its ``run_walnuts_fused`` calls makes,
    against a call's wall at ``ROUNDS`` rounds."""
    import torch
    from walnuts_tpu_torch.examples import stock_watson as swx
    from walnuts_tpu_torch.utils.parity import EXACT

    target = tw.targets.stock_watson(proper=True)
    D = target.dim
    C = SW_CHAINS
    jax_runs = _example_runs()
    q0 = swx.start_point("mode", C, D, mode)
    wall_per_launch = []
    for tag in SW_ARMS:
        (_, integ, h0, igr, _, m), = [c for c in swx.CONFIGS if c[0] == tag]
        cfg = tw.WalnutsConfig(m=m, integrator=integ,
                               igr=tw.IntegratorConfig(**igr))
        h = torch.full((C,), h0, device=dev)
        dl = torch.full((C,), swx.DELTA0, device=dev)
        seeds = swx.arm_seeds(tag)
        # float64 at the arm's shape: the kernel at this m against the
        # twin under the exact contract
        kw = dict(target=target, cfg=cfg, num_iter=SW_ARM_BURNIN,
                  stop_mode="min_per_chain", rounds=160, diag_rows=8,
                  device=dev)
        q64, h64, dl64 = (x.double() for x in (q0, h, dl))
        launches = rk.launches
        a = rk.pack(mk.run_walnuts_fused(seeds["burnin"], q64, h64, dl64,
                                         **kw)[-1])
        b = rk.pack(mk.run_walnuts_fused_plain(seeds["burnin"], q64, h64,
                                               dl64, **kw)[-1])
        torch.cuda.synchronize()
        rk.launches = launches
        err64 = _banks_compare(a, b, **EXACT)
        log(f"phase 9d {tag} (m={m}) f64 kernel vs plain at the arm's shape "
            f"(C={C}, D={D}), 160 rounds from the harness's start: integer "
            f"banks equal, max abs float diff {err64:.3e}; EXACT holds, "
            f"worst error over its bound {_contract_ratio(a, b, **EXACT):.3g}")
        del a, b
        frac, err, rel = _sw_twin_check(
            mk, rk, target, cfg, q0, h, dl, seeds["burnin"], SW_ARM_BURNIN,
            skip_rows=SW_ENERGY_ROWS)
        log(f"phase 9d {tag} (m={m}) f32/bf16 kernel vs plain at the arm's "
            f"shape, 16 rounds from the harness's start: integer state equal "
            f"on {frac:.4f} of chains; on those, max abs float diff "
            f"{err:.3e} (rtol 1e-4, atol 1e-3, slab rtol 2^-7) outside the "
            f"rows {', '.join(SW_ENERGY_ROWS)}, whose largest relative "
            f"difference is {rel:.3e} (held in float64 above)")

        rk.launches = 0
        res, st = swx.run_arm(tag, chains=C, iters=SW_ARM_ITERS,
                              burnin=SW_ARM_BURNIN, q0=q0, device=dev)
        launches = rk.launches
        if launches == 0:
            raise AssertionError(f"9d {tag}: the kernel was never launched")
        if tuple(st.samples.shape) != (SW_ARM_ITERS, C, D) or \
                not bool(torch.isfinite(st.samples).all()):
            raise AssertionError(f"9d {tag}: bad draws "
                                 f"{tuple(st.samples.shape)}")
        if int(st.it.min()) < SW_ARM_ITERS:
            raise AssertionError(f"9d {tag}: a chain is short of its quota")
        wall = res["seconds"]
        ph = res["phases"]
        wall_per_launch.append(wall / launches)
        log(f"phase 9d {tag} through the harness: proper model D={D} C={C} "
            f"m={m} H0 {h0} f32, fixed tuning: {SW_ARM_BURNIN} burn-in "
            f"transitions in {ph['burnin']['seconds']:.2f} s, "
            f"{SW_ARM_ITERS} draws in {ph['sample']['seconds']:.2f} s "
            f"({ph['burnin']['calls']} + {ph['sample']['calls']} calls): "
            f"wall {wall:.2f} s, {res['grad_evals']:.0f} grad evals = "
            f"{res['grad_evals_per_s']:.1f} grad-evals/s, "
            f"{C * SW_ARM_ITERS / ph['sample']['seconds']:.1f} draws/s; "
            f"kernel launches {launches} ({1e3 * wall / launches:.4f} ms of "
            f"wall each); on {CARD}")

        ms, _, k_runs, _, bound = _sw_timing(
            mk, rk, target, cfg, st.qc, h, dl, seeds["sample"], SW_ARM_ITERS,
            plain=False)
        log(f"phase 9d {tag} timing from the arm's chains, 256 rounds: "
            f"kernel {ms:.4f} ms per 16-round launch "
            f"({[round(t, 4) for t in k_runs]}); bound {bound[0]:.4f} ms "
            f"({bound[1]}: {bound[2]}), kernel at {bound[0] / ms:.1%} of "
            f"it; on {CARD}")

        ref = jax_runs[tag]

        def band(r, k):
            return " / ".join(f"{r['bands'][k][q]:.4f}"
                              for q in ("q10", "q50", "q90"))

        bands = "; ".join(f"{k} {band(res, k)} (example {band(ref, k)})"
                          for k in ("sigma", "z", "x", "tau"))
        log(f"phase 9d {tag} statistics over {SW_ARM_ITERS} draws x {C} "
            f"chains (reported, not gated, at this depth): split-Rhat all "
            f"coordinates {res['max_split_rhat_all_coords']:.4f} (example "
            f"{ref['max_split_rhat_all_coords']:.4f} over "
            f"{ref['stamp']['iters']} draws x {ref['stamp']['chains']}); "
            f"bands q10 / q50 / q90: {bands}; band gap to the example's arm "
            f"{swx.band_gap(res, ref):.4f}")

    # the harness's calls each pack their state, which copies the ring
    R, Cr = SW_RING
    st0 = mk.init_state(q0[:Cr], h[:Cr], dl[:Cr], target=target, cfg=cfg,
                        warmup=None, num_iter=R, diag_rows=8)
    copies = []
    for _ in range(3):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        banks = rk.pack(st0)
        e1.record()
        torch.cuda.synchronize()
        copies.append(e0.elapsed_time(e1))
        del banks
    copy = min(copies)
    call = swx.ROUNDS / mk.FLUSH_EVERY * 1e3 * max(wall_per_launch)
    log(f"phase 9d ring copy: packing a state whose ring holds {R} draws x "
        f"{Cr} chains x {D} (f32, {st0.samples.nbytes / 1e9:.2f} GB) takes "
        f"{copy:.3f} ms ({[round(t, 3) for t in copies]}) by CUDA events, "
        f"{copy / call:.2%} of a {swx.ROUNDS}-round call at 9d's "
        f"{1e3 * max(wall_per_launch):.4f} ms of wall per launch; on {CARD}")
    del st0


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


# ---------------------------------------------------------------------------
# phase 10: chains split over ranks, the native oracle, what the kernel
# does not fuse
# ---------------------------------------------------------------------------

# Both ranks of 10a and 10b share the one card, so they join over gloo
# (parallel.rank_layout: NCCL refuses two ranks on one GPU).
RANKS_ON = "cuda:0"


def _rank_device():
    """The card a rank of phase 10 runs on (``run_ranks`` made it the
    rank's current card)."""
    import torch

    return torch.device(RANKS_ON)


def _exact_case(tw, dev):
    """10a's float64 invocation: funnel(11), 64 chains, m=4, 160 rounds
    of pooled warmup in ``per_chain`` mode."""
    import torch

    C, D = 64, 11
    g = torch.Generator(device="cpu").manual_seed(1234)
    q0 = (0.3 * torch.randn(C, D, generator=g, dtype=torch.float64)).to(dev)
    h = torch.full((C,), 0.4, dtype=torch.float64, device=dev)
    dl = torch.full((C,), 0.15, dtype=torch.float64, device=dev)
    kw = dict(target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=4),
              num_iter=20, stop_mode="per_chain", rounds=160, diag_rows=8,
              warmup=tw.WarmupConfig(warmup_iter=20, pooled=True),
              device=dev)
    return q0, h, dl, kw


def rank_fused_exact():
    """10a, on each rank: the rank's block of the float64 invocation
    through the kernel; returns its banks on the host and its launches."""
    import torch
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch import parallel
    from walnuts_tpu_torch.sampler import megakernel as mk
    from walnuts_tpu_torch.sampler import round_kernel as rk

    dev = _rank_device()
    mesh = parallel.make_mesh()
    q0, h, dl, kw = _exact_case(tw, dev)
    q0, h, dl = parallel.shard_chains((q0, h, dl), mesh)
    rk.launches = 0
    st = mk.run_walnuts_fused(2718, q0, h, dl, mesh=mesh, **kw)[-1]
    torch.cuda.synchronize()
    return dict(banks=[t.cpu() for t in rk.pack(st)], launches=rk.launches)


# the chain axis of each bank (sf, si, vx, slab_q, slab_v, samples, diags)
BANK_CHAIN_AXES = (1, 1, 0, 0, 0, 1, 1)


def phase_ranks_exact(tw, mk, rk, dev):
    """10a: the fused engine over two gloo ranks on the card, exact:
    the ranks' banks, joined in rank order, against one process's."""
    import torch
    from walnuts_tpu_torch.parallel import run_ranks

    q0, h, dl, kw = _exact_case(tw, dev)
    rk.launches = 0
    one = rk.pack(mk.run_walnuts_fused(2718, q0, h, dl, **kw)[-1])
    torch.cuda.synchronize()
    one_launches = rk.launches
    t0 = time.perf_counter()
    outs = run_ranks(rank_fused_exact, 2, timeout=300, device=RANKS_ON)
    wall = time.perf_counter() - t0
    joined = rk.Banks(*(torch.cat([o["banks"][i] for o in outs], dim=ax)
                        .to(dev) for i, ax in enumerate(BANK_CHAIN_AXES)))
    err = _banks_compare(joined, one, rtol=1e-9, atol=1e-12)
    bitwise = all(torch.equal(a, b) for a, b in zip(joined, one))
    per_rank = [o["launches"] for o in outs]
    if per_rank != [one_launches] * 2:
        raise AssertionError(f"10a: launches per rank {per_rank} against "
                             f"{one_launches} in one process")
    it = rk.I_FIELDS.index("it")
    log(f"phase 10a fused engine over 2 gloo ranks on the card, f64 "
        f"funnel(11) C=64 (32 per rank) m=4, 160 rounds, pooled warmup, "
        f"kernel: joined banks == one process's: integer banks equal, max "
        f"abs float diff {err:.3e} (rtol 1e-9, atol 1e-12), bitwise "
        f"{bitwise}; launches per rank {per_rank} (one process "
        f"{one_launches}); draws {int(one.si[it].sum())}; {wall:.1f} s with "
        f"the ranks' start")


def rank_main_path():
    """10b, on each rank: the main path on the rank's 4096 chains, then
    the collectives' cost per launch at this shape."""
    import torch
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch import parallel
    from walnuts_tpu_torch.sampler import megakernel as mk
    from walnuts_tpu_torch.sampler import round_kernel as rk

    dev = _rank_device()
    mesh = parallel.make_mesh()
    r = run_main_path(tw, mk, rk, dev, mesh)

    # the collectives of a warmup period when the stop test is read
    # (its all-reduce, once a turn of the host loop, and the consensus'
    # all-gather of three rows, every period), against the one-process
    # stop test's host sync alone
    st, n = r["final"], 200
    rows = torch.stack([st.it.to(st.h_cur.dtype), st.h_cur, st.delta_cur])
    timings = []
    for m in (mesh, None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            parallel.reduce_int((st.it < MAIN_ITERS).any(), m, "max")
            if m is not None:
                parallel.gather_rows(rows, m, dim=1)
        torch.cuda.synchronize()
        timings.append((time.perf_counter() - t0) / n * 1e3)
    return dict(launches=r["launches"], warm_launches=r["warm_launches"],
                grads=r["grads"],
                draws=r["draws"].cpu(), t_warm=r["t_warm"],
                t_timed=r["t_timed"], coll_ms=timings[0], sync_ms=timings[1],
                h=float(r["warm"].h_cur.median()),
                delta=float(r["warm"].delta_cur.median()))


def phase_ranks_main(tw, mk, rk, dev, main_run):
    """10b: the main path at full width over two gloo ranks on the one
    card (4096 chains each): every rank's launches, the summed grads,
    the joined draws and their ESS equal phase 4's bit for bit."""
    import torch
    from walnuts_tpu_torch.diagnostics import ess
    from walnuts_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    outs = run_ranks(rank_main_path, 2, timeout=600, device=RANKS_ON)
    wall = time.perf_counter() - t0
    draws = torch.cat([o["draws"] for o in outs], dim=1).to(dev)
    grads = sum(o["grads"] for o in outs)
    ess_vals = ess(draws.double())
    launches = [o["launches"] for o in outs]
    t_timed = max(o["t_timed"] for o in outs)
    t_warm = max(o["t_warm"] for o in outs)
    sd_err = abs(float(draws[..., 0].double().std()) - 3.0)
    log(f"phase 10b main path over 2 gloo ranks on the card: funnel(101) "
        f"C={MAIN_C} ({MAIN_C // 2} per rank) m={MAIN_M} f32, "
        f"{MAIN_WARMUP} pooled warmup + {MAIN_ITERS} draws: warmup "
        f"{t_warm:.2f} s (phase 4 "
        f"{main_run['t_warm']:.2f} s), timed {t_timed:.2f} s (phase 4 "
        f"{main_run['t_timed']:.2f} s): {grads} grad evals = "
        f"{grads / t_timed:.1f} grad-evals/s (phase 4 "
        f"{main_run['grads'] / main_run['t_timed']:.1f}), ESS "
        f"{[round(float(e), 1) for e in ess_vals]}, min-ESS/s "
        f"{float(ess_vals.min()) / t_timed:.2f} (phase 4 "
        f"{float(main_run['ess'].min()) / main_run['t_timed']:.2f}), "
        f"|sd(omega) - 3| = {sd_err:.4f}; launches per rank {launches} "
        f"(phase 4 {main_run['launches']}); adapted H median "
        f"{outs[0]['h']:.4f}, delta median {outs[0]['delta']:.4f}; "
        f"{wall:.1f} s with the ranks' start; on {CARD}")
    log(f"phase 10b collectives of a warmup period that reads the stop "
        f"test (stop-test all-reduce + "
        f"consensus all-gather of 3 x {MAIN_C // 2}, gloo through the "
        f"host, 200 "
        f"times): {[round(o['coll_ms'], 4) for o in outs]} ms per rank, "
        f"against {[round(o['sync_ms'], 4) for o in outs]} ms for the "
        f"one-process stop test's sync; on {CARD}")
    if launches != [main_run["launches"]] * 2:
        raise AssertionError(f"10b: launches per rank {launches}, phase 4 "
                             f"{main_run['launches']}")
    if grads != main_run["grads"]:
        raise AssertionError(f"10b: {grads} grads, phase 4 "
                             f"{main_run['grads']}")
    if not torch.equal(draws, main_run["draws"]):
        raise AssertionError("10b: the joined draws differ from phase 4's")
    if not torch.equal(ess_vals, main_run["ess"]):
        raise AssertionError(f"10b: ESS {ess_vals.tolist()}, phase 4 "
                             f"{main_run['ess'].tolist()}")
    if not sd_err < 0.3:
        raise AssertionError(f"10b: |sd(omega) - 3| = {sd_err:.4f} >= 0.3")


# 10c's card run: funnel(11) chains and draws per chain (the first 100
# are dropped); test_native.py's JAX side runs 64 chains x 500.
NATIVE_CHAINS, NATIVE_ITERS = 1024, 500


def phase_native(tw, mk, rk, dev):
    """10c: the native C++ engine (the CPU oracle, built from
    ``native/walnuts_engine.cpp`` by ``walnuts_tpu_torch.native``)
    against the fused engine on the card, with the gates of
    ``tests/test_native.py``'s engine-agreement test on omega's mean,
    sd, left-tail mass and quartiles."""
    import numpy as np
    import torch
    from walnuts_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_n = np.concatenate([
        native.run("funnel", 11, np.zeros(11), 20000, h0=0.3, delta=0.3,
                   m=9, seed=s)[0][2000:, 0] for s in (3, 4, 5)])
    t_native = time.perf_counter() - t0

    C, N = NATIVE_CHAINS, NATIVE_ITERS
    g = torch.Generator(device=dev).manual_seed(3)
    q0 = 0.1 * torch.randn(C, 11, generator=g, device=dev,
                           dtype=torch.float64)
    rk.launches = 0
    t0 = time.perf_counter()
    out = mk.run_walnuts_fused(
        41, q0, torch.full((C,), 0.3, dtype=torch.float64, device=dev),
        torch.full((C,), 0.3, dtype=torch.float64, device=dev),
        target=tw.targets.funnel(11), cfg=tw.WalnutsConfig(m=9),
        num_iter=N, device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    if rk.launches == 0:
        raise AssertionError("10c: the fused engine made no kernel launch")
    w_j = out[0][100:, :, 0].cpu().numpy().ravel()
    stats = {
        "mean": (w_n.mean(), w_j.mean(), 0.45),
        "sd": (w_n.std(), w_j.std(), 0.3),
        "P(omega < -3)": ((w_n < -3).mean(), (w_j < -3).mean(), 0.05),
    }
    for p in (0.25, 0.5, 0.75):
        stats[f"q{p:g}"] = (np.quantile(w_n, p), np.quantile(w_j, p), 0.5)
    text = "; ".join(f"{k} {a:.4f} vs {b:.4f} (gate {t})"
                     for k, (a, b, t) in stats.items())
    log(f"phase 10c native oracle vs the card: native funnel(11) m=9, 3 "
        f"chains x 18000 draws after 2000 ({path.name} built in "
        f"{t_build:.1f} s, sampled in {t_native:.1f} s) vs the fused "
        f"engine f64 funnel(11) C={C} m=9 h=delta=0.3 fixed, {N - 100} "
        f"draws after 100 ({rk.launches} kernel launches, {t_card:.1f} s): "
        f"{text}")
    bad = [k for k, (a, b, t) in stats.items() if not abs(a - b) < t]
    if bad:
        raise AssertionError(f"10c: native and card disagree on {bad}")


def _bench_summary(q):
    """``bench.py``'s (omega, sum x^2) summary written as a function of
    its own: not ``omega_sumsq``, so the kernel does not store it."""
    import torch

    return torch.stack([q[..., 0], torch.sum(q[..., 1:] ** 2, dim=-1)], -1)


def phase_card_route(tw, mk, rk, dev):
    """10d: what the kernel does not fuse, on the card, through
    ``run_walnuts_fused``.  A summary the kernel does not store
    (``bench.py``'s, as a function of its own) runs through the kernel,
    which stages positions for torch to map: equal to the CPU run under
    EXACT in float64, and at the main path's timed shape against
    ``omega_sumsq`` stored in the kernel.  A target without a fused
    gradient (``smile``) runs through the kernel's external-gradient
    segments (phase 11), equal to the CPU run under EXACT."""
    import torch

    C = 64
    for name, target, counter in (
            ("funnel(7) with bench.py's summary", tw.targets.funnel(
                7, generated=_bench_summary), "launches"),
            ("smile through the external-gradient segments",
             tw.targets.smile(), "segment_launches")):
        g = torch.Generator(device="cpu").manual_seed(9)
        q0 = 0.3 * torch.randn(C, target.dim, generator=g,
                               dtype=torch.float64)
        kw = dict(target=target, cfg=tw.WalnutsConfig(m=5), num_iter=12,
                  stop_mode="per_chain", rounds=160, diag_rows=4,
                  micro_unroll=2)
        h = torch.full((C,), 0.3, dtype=torch.float64)
        dl = torch.full((C,), 0.2, dtype=torch.float64)
        rk.launches = rk.segment_launches = 0
        t0 = time.perf_counter()
        card = mk.run_walnuts_fused(31, q0, h, dl, device=dev, **kw)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches = getattr(rk, counter)
        if launches == 0 or rk.launches + rk.segment_launches != launches:
            raise AssertionError(
                f"10d {name}: {rk.launches} kernel launches, "
                f"{rk.segment_launches} segment launches")
        cpu = mk.run_walnuts_fused(31, q0, h, dl, device="cpu", **kw)
        a = rk.Banks(*(t.cpu() for t in rk.pack(card[-1])))
        err = _banks_compare(a, rk.pack(cpu[-1]), rtol=1e-9, atol=1e-12)
        if card[4] != cpu[4]:
            raise AssertionError(f"10d {name}: grads {card[4]} vs {cpu[4]}")
        log(f"phase 10d {name}, f64 C={C} m=5, 160 rounds: card == CPU, "
            f"integer banks equal, max abs float diff {err:.3e} (rtol "
            f"1e-9, atol 1e-12); {counter} {launches}; draws "
            f"{int(card[3].sum())}, {t_card:.2f} s on the card")

    # the main path's timed shape, 1600 rounds from the same start: the
    # summary as a function of its own against omega_sumsq in the kernel
    g = torch.Generator(device=dev).manual_seed(5)
    q0 = 0.3 * torch.randn(MAIN_C, MAIN_D, generator=g, device=dev)
    h = torch.full((MAIN_C,), 0.3, device=dev)
    kw = dict(cfg=tw.WalnutsConfig(m=MAIN_M), num_iter=MAIN_ITERS,
              stop_mode="min_per_chain", diag_rows=8, micro_unroll=4,
              rounds=1600, device=dev)
    outs, ms = {}, {}
    for name in ("omega_sumsq", "own", "own", "omega_sumsq"):
        gen = tw.targets.omega_sumsq if name == "omega_sumsq" else \
            _bench_summary
        rk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mk.run_walnuts_fused(
            13, q0, h, h, target=tw.targets.funnel(MAIN_D, generated=gen),
            **kw)
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3 / rk.launches
        ms[name] = min(ms.get(name, t), t)
        outs[name] = out
    a, b = outs["own"], outs["omega_sumsq"]
    if not (torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
            and a[4] == b[4]):
        raise AssertionError("10d: the summary changed the chains' path")
    s_err = float((a[0] - b[0]).abs().max())
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-5)
    log(f"phase 10d main path's timed shape (funnel({MAIN_D}) C={MAIN_C} "
        f"m={MAIN_M} f32, 1600 rounds): bench.py's summary mapped in torch "
        f"{ms['own']:.4f} ms per launch against omega_sumsq in the kernel "
        f"{ms['omega_sumsq']:.4f} ms (wall, best of 2); positions, counts "
        f"and grads equal, draws within {s_err:.3e}; on {CARD}")


# ---------------------------------------------------------------------------
# phases 10e-10g: the scan engine on a (chains, dim) mesh, the streaming
# engine and the isokinetic line with their chains over ranks, then on
# the (chains, dim) mesh
# ---------------------------------------------------------------------------

# 10e(b) runs this many transitions of 6b's run (the README width, from
# 6b's start) on a (2, 2) mesh of gloo ranks sharing the card, and times
# this many dim-group all-reduces at its shape.
DIM_ITERS, DIM_COLL_REPS = 1, 200
# 10g(a) runs 10f's streaming and generic-NUTS cases for this many
# transitions (10f runs 10) and the Newton case for DIM_NEWTON_ITERS;
# 10g(b) runs this many generic-NUTS iterations of 8b's iso_std arm on
# the (2, 2) mesh.  The cuts keep 10g near 60 s at the 3-6 ms per
# dim-group collective measured there on an H100.
DIM_B_ITERS, DIM_NEWTON_ITERS, DIM_ISO_ITERS = 3, 1, 1
# the multinomial diagnostics that are integers (its DIAG_COLS)
MULTI_INT_COLS = [1, 2, 3, 4, 6, 9]


def _dim_exact_runs(tw, dev, mesh=None):
    """10e(a): float64 funnel(11), 16 chains (columns 6 + 5 on a dim
    split), m=5, R2P, 5 transitions without adaptation, then 5 of pooled
    warmup; each run's samples, diagnostics, final H and delta and final
    positions, joined over ``mesh``'s axes (whole without one)."""
    import torch
    from walnuts_tpu_torch import parallel
    from walnuts_tpu_torch.diagnostics import gather_blocks

    C, D = 16, 11
    g = torch.Generator(device="cpu").manual_seed(77)
    q0 = (0.5 * torch.randn(C, D, generator=g, dtype=torch.float64)).to(dev)
    q = parallel.shard_chains_dim(q0, mesh)
    out = {}
    for name, warmup in (("fixed", tw.WarmupConfig(warmup_iter=0)),
                         ("pooled", tw.WarmupConfig(warmup_iter=5,
                                                    pooled=True))):
        s, d, st = tw.run_walnuts(
            4, q, target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=5),
            warmup=warmup, num_iter=5, h0=0.4, delta0=0.15, device=dev,
            mesh=mesh)
        out[name] = [gather_blocks(s, mesh), gather_blocks(d, mesh,
                                                           cols=False),
                     gather_blocks(st.h, mesh, 0, cols=False),
                     gather_blocks(st.delta, mesh, 0, cols=False),
                     gather_blocks(st.q, mesh, 0)]
    return out


_collectives = [0]  # dim-group collectives since the last reset to 0


def _count_collectives():
    """From now on, in this process, count each dim-group collective
    (``parallel.mesh``'s all-reduces and column gathers) in
    ``_collectives[0]``, by wrapping the two functions that make them."""
    from walnuts_tpu_torch.parallel import mesh as pm

    for name in ("_dim_reduce", "_gather_cols"):
        f = getattr(pm, name)
        if getattr(f, "counted", False):
            continue

        def counted(*args, _f=f):
            _collectives[0] += 1
            return _f(*args)

        counted.counted = True
        setattr(pm, name, counted)


def _part_b_runs(tw, dev, mesh=None, counts=None, iters=10):
    """10f and 10g(a): float64 runs of the streaming engine (hash and
    global draws; funnel(11), 16 chains, m=5, R2P, per-chain tuning,
    ``iters`` transitions), generic NUTS (isokinetic kernel,
    std_gauss(5), 16 chains, m=5, ``iters`` iterations) and the
    multinomial sampler (isokinetic, L=12, 12 warmup + 2 iterations),
    each run's results joined over
    ``mesh``'s axes: its chains of a 1-D mesh, its chains and columns
    (funnel(11) 6 + 5, std_gauss(5) 3 + 2) of a (chains, dim) one.
    ``counts`` (a dict) gets each run's dim-group collectives."""
    import numpy as np
    import torch
    from walnuts_tpu_torch import parallel
    from walnuts_tpu_torch.diagnostics import gather_blocks

    sp, C = tw.sampler, 16
    rng = np.random.default_rng(8)
    q11 = torch.from_numpy(0.5 * rng.normal(size=(C, 11))).to(dev)
    q5 = torch.from_numpy(0.8 * rng.normal(size=(C, 5))).to(dev)
    h = torch.linspace(0.25, 0.5, C, dtype=torch.float64, device=dev)
    dl = torch.linspace(0.08, 0.3, C, dtype=torch.float64, device=dev)
    q11, q5, h, dl = parallel.shard_chains_dim((q11, q5, h, dl), mesh)

    def cols(x, chain_dim=1):
        return gather_blocks(x, mesh, chain_dim)

    def rows(x, chain_dim=1):
        return gather_blocks(x, mesh, chain_dim, cols=False)

    def run(name, fn):
        _count_collectives()
        _collectives[0] = 0
        out[name] = fn()
        if counts is not None:
            counts[name] = _collectives[0]

    def streaming(rng_mode):
        s, d, qf = sp.run_walnuts_streaming(
            5, q11, h, dl, target=tw.targets.funnel(11),
            cfg=tw.WalnutsConfig(m=5), num_iter=iters, rng=rng_mode,
            device=dev, mesh=mesh)
        return [cols(s), rows(d), cols(qf, 0)]

    def generic():
        s, d = sp.run_generic_nuts(
            11, q5, target=tw.targets.std_gauss(5),
            kernel=sp.IsokineticKernel(), h_macro=0.5, delta=0.1,
            num_iter=iters, m=5, device=dev, mesh=mesh)
        return [cols(s), rows(d)]

    def multinomial():
        s, d, (hm, dm) = sp.run_multinomial(
            17, q5, target=tw.targets.std_gauss(5),
            kernel=sp.IsokineticKernel(),
            cfg=sp.MultinomialConfig(l_orbit=12), h0=0.6, delta0=0.2,
            num_iter=14, warmup_iter=12, device=dev, mesh=mesh)
        return [cols(s), rows(d), rows(hm, 0), rows(dm, 0)]

    out = {}
    for rng_mode in ("hash", "global"):
        run(f"streaming {rng_mode}", lambda: streaming(rng_mode))
    run("generic NUTS", generic)
    run("multinomial", multinomial)
    return out


def _newton_runs(tw, dev, mesh=None, counts=None):
    """10g(a): float64 funnel(11), 16 chains (columns 6 + 5 on a dim
    split), m=4, the implicit midpoint in Newton mode with a ``[D]``
    inverse mass, ``DIM_NEWTON_ITERS`` transitions without adaptation:
    samples, diagnostics and final positions, joined over ``mesh``'s
    axes."""
    import numpy as np
    import torch
    from walnuts_tpu_torch import parallel
    from walnuts_tpu_torch.diagnostics import gather_blocks

    C, D = 16, 11
    rng = np.random.default_rng(9)
    q0 = torch.from_numpy(0.5 * rng.normal(size=(C, D))).to(dev)
    _count_collectives()
    _collectives[0] = 0
    s, d, st = tw.run_walnuts(
        6, parallel.shard_chains_dim(q0, mesh), target=tw.targets.funnel(D),
        cfg=tw.WalnutsConfig(m=4, integrator="adapt_implicit_midpoint_d",
                             use_inv_mass=True,
                             igr=tw.ops.IntegratorConfig(fp_newton=True)),
        warmup=tw.WarmupConfig(warmup_iter=0), num_iter=DIM_NEWTON_ITERS,
        h0=0.4, delta0=0.15,
        inv_mass=torch.linspace(0.6, 1.5, D, dtype=torch.float64),
        device=dev, mesh=mesh)
    if counts is not None:
        counts["Newton"] = _collectives[0]
    return {"Newton": [gather_blocks(s, mesh), gather_blocks(d, mesh,
                                                             cols=False),
                       gather_blocks(st.q, mesh, 0)]}


def _iso_dim_run(tw, dev, mesh):
    """10g(b): ``DIM_ISO_ITERS`` generic-NUTS iterations of 8b's iso_std
    arm (isokinetic kernel, D = 10^4, 32 chains, m = 9, f32, the
    example's key and exact start) on the rank's block of ``mesh``: its
    wall, dim-group collectives and own diagnostics, and the joined
    draws and diagnostics."""
    import torch
    from walnuts_tpu_torch import parallel
    from walnuts_tpu_torch.diagnostics import gather_blocks
    from walnuts_tpu_torch.examples import highdim_variants as hv
    from walnuts_tpu_torch.utils import threefry

    C, D = ISO_CHAINS, ISO_DIM
    target = hv.make_target("iso_std", D, torch.float32)
    key = threefry.PRNGKey(sum(map(ord, "iso_std")), dev)
    q = parallel.shard_chains_dim(threefry.normal(key, (C, D),
                                                  torch.float32), mesh)
    _count_collectives()
    _collectives[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, d = tw.sampler.run_generic_nuts(
        threefry.fold_in(key, 1), q, target=target,
        kernel=tw.sampler.IsokineticKernel(), h_macro=1.4 * D ** -0.25,
        delta=0.2, num_iter=DIM_ISO_ITERS, m=ISO_M, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    return dict(wall=time.perf_counter() - t0, coll=_collectives[0],
                block=tuple(q.shape), diag_local=d.cpu(),
                draws=gather_blocks(s, mesh, cols=False).cpu(),
                diag=gather_blocks(d, mesh, cols=False).cpu())


def rank_dim_split():
    """10e, 10f and 10g, on each rank of a (2, 2) mesh: 10e (a) the
    float64 runs on the rank's block, (b) 6b's run at the README width
    for ``DIM_ITERS`` transitions with its dim-group collectives counted
    and then timed; 10f's runs on the rank's chains of the mesh's chains
    axis (two ranks; both columns of the mesh run them alike); 10g (a)
    the same runs and the Newton mode on the rank's block of the whole
    mesh, (b) 8b's iso_std arm there."""
    import torch
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch import parallel
    from walnuts_tpu_torch.diagnostics import gather_blocks
    from walnuts_tpu_torch.sampler import round_kernel as rk

    def host(tree):
        return {k: [t.cpu() for t in v] for k, v in tree.items()}

    dev = _rank_device()
    mesh = parallel.make_mesh2(2, 2)
    out = dict(exact=host(_dim_exact_runs(tw, dev, mesh)),
               part_b=host(_part_b_runs(tw, dev, mesh["chains"])),
               coords=tuple(mesh.get_coordinate()))

    C, D = SCAN_CHAINS, SCAN_DIM
    g = torch.Generator(device=dev).manual_seed(0)
    q0 = 0.1 * torch.randn(C, D, generator=g, device=dev)    # 6b's start
    q = parallel.shard_chains_dim(q0, mesh)
    _count_collectives()
    _collectives[0] = rk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, d, st = tw.run_walnuts(
        7, q, target=tw.targets.funnel(D),
        cfg=tw.WalnutsConfig(m=10, integrator="adapt_leapfrog_r2p"),
        warmup=tw.WarmupConfig(warmup_iter=SCAN_WARMUP), num_iter=DIM_ITERS,
        h0=0.3, delta0=0.3, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    out.update(wall=time.perf_counter() - t0, coll=_collectives[0],
               launches=rk.launches, block=tuple(q.shape),
               diag_local=d.cpu())
    s, d = gather_blocks(s, mesh), gather_blocks(d, mesh, cols=False)
    codes = _scan_check("10e(b)", s, d, C, D)
    out.update(codes={c: int((d[..., 19] == c).sum()) for c in codes},
               grads=int(d[..., 6].double().sum() + d[..., 7].double().sum()),
               depth_mean=float(d[..., 20].double().mean()),
               depth_max=int(d[..., 20].max()), c_max=int(d[..., 22].max()))

    # one dim-group all-reduce at this shape: the stacked pair of
    # per-chain partial sums that the U-turn checks and the funnel's
    # gradient send
    x = torch.ones(2, q.shape[0], device=dev)
    with parallel.dim_split(mesh, D):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIM_COLL_REPS):
            parallel.dim_sum(x[0], x[1])
        torch.cuda.synchronize()
    out["coll_ms"] = (time.perf_counter() - t0) / DIM_COLL_REPS * 1e3

    counts = {}
    t0 = time.perf_counter()
    out["dim_b"] = host({**_part_b_runs(tw, dev, mesh, counts, DIM_B_ITERS),
                         **_newton_runs(tw, dev, mesh, counts)})
    out.update(dim_b_coll=counts, dim_b_wall=time.perf_counter() - t0)
    out["iso"] = _iso_dim_run(tw, dev, mesh)
    return out


def _within(name, want, got, contract, int_cols=()):
    """Ranks' joined tensor ``got`` against one process's ``want``:
    integer columns equal, all within ``contract``; returns the largest
    difference and whether the bits are equal."""
    import torch

    err = _assert_same(name, want, got, contract, int_cols)
    return err, torch.equal(want.cpu(), got.cpu())


def phase_dim_split(tw, rk, dev, scan_s_per_it, iso_s_per_it):
    """10e: the scan engine on a (2, 2) mesh of four gloo ranks on the
    card (chains over the mesh's rows, columns over its columns, every
    sum over D all-reduced over the dim group): (a) float64 against one
    process on the card, under EXACT without adaptation and ADAPTIVE
    with pooled warmup; (b) 6b's run at the README width (funnel(101)
    split 51 + 50, 4096 chains, m=10, R2P, float32) for ``DIM_ITERS``
    transitions: s per transition beside 6b's, dim-group collectives per
    transition and their ms, stop codes and depths; the gate is finite
    results and valid stop codes.  10f: the streaming engine (both
    draws), generic NUTS and the multinomial sampler over two ranks
    against one process on the card, under EXACT.  10g: (a) the same
    runs and the Newton mode on the whole mesh against one process on
    the card, under EXACT and (the multinomial sampler's warmup)
    ADAPTIVE; (b) one generic-NUTS iteration of 8b's iso_std arm there,
    beside ``iso_s_per_it`` (8b's s per iteration): its wall, dim-group
    collectives per iteration, finite draws and the same diagnostics
    rows within each dim group."""
    import torch
    from walnuts_tpu_torch.parallel import run_ranks
    from walnuts_tpu_torch.utils.parity import (ADAPTIVE, ENERGY_RANGE,
                                                ENERGY_RANGE_COL, EXACT)

    int_cols = SCAN_INT_COLS
    one_exact = _dim_exact_runs(tw, dev)
    one_b = _part_b_runs(tw, dev)
    one_g = {**_part_b_runs(tw, dev, iters=DIM_B_ITERS),
             **_newton_runs(tw, dev)}
    t0 = time.perf_counter()
    outs = run_ranks(rank_dim_split, 4, timeout=600, device=RANKS_ON)
    wall = time.perf_counter() - t0

    names = ("samples", "diagnostics", "H", "delta", "q")
    for run, contract, what in (("fixed", EXACT, "without adaptation"),
                                ("pooled", ADAPTIVE, "of pooled warmup")):
        errs, bits = [], []
        for rank in outs:
            for name, w, g in zip(names, one_exact[run], rank["exact"][run]):
                ic = int_cols if name == "diagnostics" else ()
                if ic and contract is ADAPTIVE:   # column 17 on its own
                    _assert_same("10e(a) energy range",
                                 w[..., ENERGY_RANGE_COL],
                                 g[..., ENERGY_RANGE_COL], ENERGY_RANGE)
                    cols = [c for c in range(24) if c != ENERGY_RANGE_COL]
                    w, g = w[..., cols], g[..., cols]
                    ic = [cols.index(c) for c in int_cols]
                e, b = _within(f"10e(a) {run} {name}", w, g, contract, ic)
                errs.append(e)
                bits.append(b)
        log(f"phase 10e(a) scan engine on a (2, 2) mesh of gloo ranks on "
            f"the card, f64 funnel(11) C=16 (columns 6 + 5) m=5 R2P, 5 "
            f"transitions {what}: every rank's joined run == one process "
            f"on the card within "
            f"{'EXACT' if contract is EXACT else 'ADAPTIVE'} (rtol "
            f"{contract['rtol']:g}, atol {contract['atol']:g}), integer "
            f"diagnostics equal, max abs diff {max(errs):.3e}, bitwise "
            f"{all(bits)}")

    # (b): the pairs of a dim group hold the same rows, bit for bit
    for a, b in ((0, 1), (2, 3)):
        if not torch.equal(outs[a]["diag_local"], outs[b]["diag_local"]):
            raise AssertionError(f"10e(b): ranks {a} and {b} (one dim "
                                 "group) hold different diagnostics")
    r0 = outs[0]
    coll = [o["coll"] / DIM_ITERS for o in outs]
    s_it = max(o["wall"] for o in outs) / DIM_ITERS
    log(f"phase 10e(b) scan engine on a (2, 2) mesh, README width: "
        f"funnel({SCAN_DIM}) C={SCAN_CHAINS} m=10 R2P f32 from 6b's start, "
        f"blocks {r0['block']} (chains x columns) per rank, "
        f"{DIM_ITERS} transitions of per-chain warmup in "
        f"{max(o['wall'] for o in outs):.2f} s = {s_it:.3f} s per "
        f"transition (6b, one process, {SCAN_WARMUP + SCAN_ITERS} "
        f"transitions: {scan_s_per_it:.3f} s per transition); dim-group "
        f"collectives per transition per rank "
        f"{[round(c, 1) for c in coll]}, one all-reduce of 2 x "
        f"{SCAN_CHAINS // 2} f32 (gloo through the host, "
        f"{DIM_COLL_REPS} times) "
        f"{[round(o['coll_ms'], 4) for o in outs]} ms per rank; stop codes "
        f"{r0['codes']}, orbit depth mean {r0['depth_mean']:.2f}, worst "
        f"{r0['depth_max']}, worst refinement {r0['c_max']}; {r0['grads']} "
        f"grad evals; round-kernel launches per rank "
        f"{[o['launches'] for o in outs]}; {wall:.1f} s with the ranks' "
        f"start, 10f and 10g; on {CARD}")

    for name, want in one_b.items():
        errs, bits = [], []
        for rank in (outs[0], outs[1]):     # one rank per mesh column
            for i, (w, g) in enumerate(zip(want, rank["part_b"][name])):
                ic = int_cols if name.startswith("streaming") and i == 1 \
                    else ()
                e, b = _within(f"10f {name} output {i}", w, g, EXACT, ic)
                errs.append(e)
                bits.append(b)
        log(f"phase 10f {name} over 2 gloo ranks on the card, f64, 8 "
            f"chains per rank: joined == one process on the card within "
            f"EXACT (rtol {EXACT['rtol']:g}, atol {EXACT['atol']:g}), max "
            f"abs diff {max(errs):.3e}, bitwise {all(bits)}")
    if any(o["launches"] for o in outs):
        raise AssertionError("10e(b): the scan engine launched the round "
                             "kernel")

    # 10g(a): the whole mesh against one process
    int_cols = {"streaming hash": SCAN_INT_COLS,
                "streaming global": SCAN_INT_COLS,
                "generic NUTS": GENERIC_INT_COLS,
                "multinomial": MULTI_INT_COLS, "Newton": SCAN_INT_COLS}
    for name, want in one_g.items():
        contract = ADAPTIVE if name == "multinomial" else EXACT
        errs, bits = [], []
        for rank in outs:
            for i, (w, g) in enumerate(zip(want, rank["dim_b"][name])):
                e, b = _within(f"10g(a) {name} output {i}", w, g, contract,
                               int_cols[name] if i == 1 else ())
                errs.append(e)
                bits.append(b)
        log(f"phase 10g(a) {name} on a (2, 2) mesh of gloo ranks on the "
            f"card, f64, 8 chains and half the columns per rank: joined == "
            f"one process on the card within "
            f"{'EXACT' if contract is EXACT else 'ADAPTIVE'} (rtol "
            f"{contract['rtol']:g}, atol {contract['atol']:g}), integer "
            f"diagnostics equal, max abs diff {max(errs):.3e}, bitwise "
            f"{all(bits)}; dim-group collectives per rank "
            f"{[o['dim_b_coll'][name] for o in outs]}")

    a_wall = max(o["dim_b_wall"] for o in outs)
    log(f"phase 10g(a) wall on the ranks {a_wall:.2f} s (slowest rank) for "
        f"{DIM_B_ITERS} streaming and generic-NUTS transitions, the "
        f"multinomial sampler's 12 + 2 and {DIM_NEWTON_ITERS} Newton "
        f"transition(s); dim-group collectives per rank "
        f"{[sum(o['dim_b_coll'].values()) for o in outs]}; on {CARD}")

    # 10g(b): 8b's iso_std arm on the whole mesh
    for a, b in ((0, 1), (2, 3)):
        if not torch.equal(outs[a]["iso"]["diag_local"],
                           outs[b]["iso"]["diag_local"]):
            raise AssertionError(f"10g(b): ranks {a} and {b} (one dim "
                                 "group) hold different diagnostics")
    iso = outs[0]["iso"]
    draws, diag = iso["draws"][1:].double(), iso["diag"]
    if tuple(draws.shape) != (DIM_ISO_ITERS, ISO_CHAINS, 3) or \
            not bool(torch.isfinite(draws).all()):
        raise AssertionError(f"10g(b): bad draws {tuple(draws.shape)}")
    iso_wall = max(o["iso"]["wall"] for o in outs)
    log(f"phase 10g(b) generic NUTS on a (2, 2) mesh, config 5 iso_std: "
        f"D={ISO_DIM} C={ISO_CHAINS} m={ISO_M} f32, blocks {iso['block']} "
        f"(chains x columns) per rank, {DIM_ISO_ITERS} iteration(s) in "
        f"{iso_wall:.2f} s (slowest rank) = {iso_wall / DIM_ISO_ITERS:.3f} s "
        f"per iteration (8b, one process: {iso_s_per_it:.3f} s per "
        f"iteration); dim-group collectives per iteration per rank "
        f"{[o['iso']['coll'] / DIM_ISO_ITERS for o in outs]}; "
        f"{float(diag[..., 7].double().sum()):.0f} grad evals; NUTtype "
        f"counts {_counts(diag[..., 6])}; orbit doublings mean "
        f"{float(diag[..., 0].double().mean()):.2f}; radius mean "
        f"{float(draws[..., 2].mean()):.1f} against D = {ISO_DIM}; "
        f"round-kernel launches per rank {[o['launches'] for o in outs]}; "
        f"on {CARD}")


# ---------------------------------------------------------------------------
# phase 11: targets without a fused gradient, through the kernel's
# external-gradient segments
# ---------------------------------------------------------------------------

# 11b runs the main path's timed phase with funnel(101) handed over as a
# user's target, at the main path's 300 draws per chain.
EXT_ITERS = MAIN_ITERS


def _user_logp(q):
    """A user's density over one ``[3]`` position, with no gradient."""
    return (-0.5 * (q[0] ** 2 + (q[1] - 0.5 * q[0] ** 2) ** 2)
            - 0.125 * q[2] ** 2)


def _sw_synthetic(tw, T=300):
    """Stock-Watson (the proper model) over a numpy-seeded synthetic
    series of ``T`` quarters, written to the build directory."""
    import numpy as np
    from walnuts_tpu_torch import _build

    rng = np.random.default_rng(T)
    y = np.cumsum(0.3 * rng.normal(size=T)) + rng.normal(size=T)
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD / f"sw_synthetic_{T}.json"
    path.write_text(json.dumps({"T": T, "y": y.tolist()}))
    return tw.targets.stock_watson(path, proper=True)


def _pending_rows_dropped(rk, b):
    """Banks ``b`` without the payload rows of the two pending slots.
    Under a summary mapped in torch the returned state's slots hold the
    summary of the staged positions, which for a slot no draw used is
    the summary of zeros, not the plain run's zeros; the slots are empty
    between periods."""
    lay = rk.layout(b.samples.shape[2])
    keep = [i for i in range(b.sf.shape[0])
            if not lay.pgen0 <= i < lay.pdiag0]
    return b._replace(sf=b.sf[keep])


def phase_external(tw, mk, rk, dev, warm, main_run, attrs):
    """Phase 11: targets without a fused gradient through the kernel's
    external-gradient instantiation (a period is ``16 * micro_unroll +
    1`` segment launches with the target's torch ``logp_grad`` between
    them, captured once as a CUDA graph and replayed).  11a: float64,
    the targets of the GPU tests, graphed and eager bit for bit, then
    against the plain twin on the card (integer banks equal, floats
    within EXACT, each period's segment count checked), and one autograd
    target against the CPU.  11b: the main path's timed phase at full
    width from phase 4's adapted chains with funnel(101) handed over as
    a user's target (its own ``logp_grad``, no ``kernel_id``): the omega
    gate, grad-evals/s and min-ESS/s; then per period the graphed
    route's ms against the eager segments', the plain twin's and the
    fused funnel kernel's in the same call, the split of a period into
    micro-step segments, round-boundary segments and torch's kernels
    under torch.profiler, graphed and eager, the bound, and one float32
    period against the twin.  No period may run eagerly for want of a
    capture.  Returns the kernels line's entry."""
    import torch
    from walnuts_tpu_torch.diagnostics import ess
    from walnuts_tpu_torch.utils.parity import EXACT

    eager0 = rk.eager_periods
    # ---- 11a ----
    C, it = 48, rk.I_FIELDS.index("it")
    pooled = tw.WarmupConfig(warmup_iter=8, pooled=True)
    t = tw.targets
    cases = [
        ("smile", t.smile(), "per_chain", 1, None),
        ("corr_gauss", t.corr_gauss(), "total", 4, None),
        ("rosenbrock", t.rosenbrock(), "min_per_chain", 4, None),
        ("mod_funnel", t.mod_funnel(), "per_chain", 2,
         tw.WarmupConfig(warmup_iter=8)),
        ("funnel_rescaled(5)", t.funnel_rescaled(5), "min_per_chain", 1,
         pooled),
        ("ill_conditioned_gauss(5)", t.ill_conditioned_gauss(5), "total", 3,
         None),
        ("a user's logp (autograd)", tw.Target(_user_logp, 3, name="user"),
         "per_chain", 4, pooled),
        ("Stock-Watson T=300 (synthetic series)", _sw_synthetic(tw),
         "min_per_chain", 4, None),
    ]
    for name, target, stop_mode, unroll, wu in cases:
        sw = target.dim == 900
        segs = rk.segment_launches
        fused = rk.launches
        caps = rk.graph_captures
        t0 = time.perf_counter()
        a, b = _pair(tw, mk, rk, dev, D=target.dim, C=8 if sw else C,
                     m=4 if sw else 5, dtype=torch.float64, rounds=160,
                     target=target, stop_mode=stop_mode, num_iter=12,
                     micro_unroll=unroll, warmup=wu, diag_rows=4,
                     h=0.02 if sw else 0.3, delta=0.3 if sw else 0.2,
                     seed=77, eager=True)
        wall = time.perf_counter() - t0
        periods = -(-160 // mk.FLUSH_EVERY)
        made = rk.segment_launches - segs
        if rk.launches != fused or made % (mk.FLUSH_EVERY * unroll + 1) or \
                not 0 < made <= periods * (mk.FLUSH_EVERY * unroll + 1):
            raise AssertionError(f"11a {name}: {made} segment launches, "
                                 f"{rk.launches - fused} fused launches")
        if sw:
            a, b = _pending_rows_dropped(rk, a), _pending_rows_dropped(rk, b)
        err = _banks_compare(a, b, **EXACT)
        log(f"phase 11a f64 segments == plain: {name} (D={target.dim}, "
            f"{stop_mode}, micro_unroll={unroll}, "
            f"{'pooled ' if wu and wu.pooled else ''}"
            f"{'warmup' if wu else 'fixed tuning'}), 160 rounds: graphed "
            f"== eager bit for bit ({rk.graph_captures - caps} capture); "
            f"integer banks equal, max abs float diff {err:.3e} (rtol "
            f"{EXACT['rtol']:g}, atol {EXACT['atol']:g}); {made} segment "
            f"launches = {made // (mk.FLUSH_EVERY * unroll + 1)} periods x "
            f"{mk.FLUSH_EVERY * unroll + 1}; draws {int(a.si[it].sum())}; "
            f"{wall:.2f} s for the three runs")
    user = tw.Target(_user_logp, 3, name="user")
    q0 = 0.3 * torch.randn(C, 3, generator=torch.Generator().manual_seed(4),
                           dtype=torch.float64)
    kw = dict(target=user, cfg=tw.WalnutsConfig(m=5), num_iter=12,
              stop_mode="per_chain", rounds=160, diag_rows=4, micro_unroll=4)
    h = torch.full((C,), 0.3, dtype=torch.float64)
    card = mk.run_walnuts_fused(5, q0, h, h, device=dev, **kw)
    cpu = mk.run_walnuts_fused(5, q0, h, h, device="cpu", **kw)
    err = _banks_compare(rk.Banks(*(x.cpu() for x in rk.pack(card[-1]))),
                         rk.pack(cpu[-1]), **EXACT)
    log(f"phase 11a f64 segments on the card == plain engine on the CPU: a "
        f"user's logp (autograd), C={C} m=5 micro_unroll=4, 160 rounds: "
        f"integer banks equal, max abs float diff {err:.3e}; draws "
        f"{int(card[3].sum())}")
    if rk.eager_periods != eager0:
        raise AssertionError(f"11a: {rk.eager_periods - eager0} periods ran "
                             "eagerly for want of a capture")

    # ---- 11b: the timed phase with funnel(101) as a user's target ----
    C, D = MAIN_C, MAIN_D
    f = tw.targets.funnel(D)
    user = tw.Target(f._logp, D, name=f"funnel_{D}_user",
                     logp_grad=f._logp_grad,
                     generated=tw.targets.omega_sumsq)
    if rk._target_id(user, D) != rk.EXTERNAL:
        raise AssertionError("11b: the user's funnel has a fused gradient")
    cfg = tw.WalnutsConfig(m=MAIN_M)
    kw = dict(target=user, cfg=cfg, num_iter=EXT_ITERS,
              stop_mode="min_per_chain", diag_rows=8, micro_unroll=4,
              rounds=12000, device=dev)
    caps = rk.graph_captures
    rk.launches = rk.segment_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, calls = None, 0
    while True:
        st = mk.run_walnuts_fused(13, warm.qc, warm.h_cur, warm.delta_cur,
                                  mk_state=st, **kw)[-1]
        calls += 1
        if int(st.it.min()) >= EXT_ITERS:
            break
        if time.perf_counter() - t0 > 400:
            raise AssertionError(f"11b reached {int(st.it.min())} of "
                                 f"{EXT_ITERS} draws in 400 s")
    torch.cuda.synchronize()
    t_ext = time.perf_counter() - t0
    launches, fused = rk.segment_launches, rk.launches
    caps = rk.graph_captures - caps
    periods = st.n // mk.FLUSH_EVERY
    if fused or launches != periods * (4 * mk.FLUSH_EVERY + 1):
        raise AssertionError(f"11b: {launches} segment launches over "
                             f"{periods} periods, {fused} fused launches")
    if rk.eager_periods != eager0 or caps != calls:
        raise AssertionError(f"11b: {caps} captures over {calls} calls, "
                             f"{rk.eager_periods - eager0} eager periods")
    draws = st.samples.double()
    if tuple(draws.shape) != (EXT_ITERS, C, 2) or \
            not bool(torch.isfinite(draws).all()):
        raise AssertionError(f"11b: bad draws {tuple(draws.shape)}")
    grads = int(st.grad_ct.to(torch.int64).sum())
    ess_vals = ess(draws)
    sd_err = abs(float(draws[..., 0].std()) - 3.0)
    log(f"phase 11b main path's timed phase through the segments: "
        f"funnel({D}) as a user's target, C={C} m={MAIN_M} f32 "
        f"micro_unroll=4, {EXT_ITERS} draws from phase 4's adapted chains "
        f"in {t_ext:.2f} s over {calls} calls ({periods} periods = "
        f"{t_ext * 1e3 / periods:.4f} ms of wall each, {launches} segment "
        f"launches, {caps} graph captures, 0 eager periods, {fused} fused "
        f"launches): {grads} grad evals = {grads / t_ext:.1f} grad-evals/s "
        f"(phase 4, the fused kernel: "
        f"{main_run['grads'] / main_run['t_timed']:.1f}), ESS "
        f"{[round(float(e), 1) for e in ess_vals]}, min-ESS/s "
        f"{float(ess_vals.min()) / t_ext:.2f} (phase 4 "
        f"{float(main_run['ess'].min()) / main_run['t_timed']:.2f}), "
        f"|sd(omega) - 3| = {sd_err:.4f}; on {CARD}")
    if not sd_err < 0.3:
        raise AssertionError(f"11b: |sd(omega) - 3| = {sd_err:.4f} >= 0.3")

    # one float32 period against the twin at this shape, graphed and
    # eager bit for bit (not counted)
    counted = rk.launches, rk.segment_launches
    a, b = _pair(tw, mk, rk, dev, D=D, C=C, m=MAIN_M, dtype=torch.float32,
                 rounds=16, target=user, num_iter=EXT_ITERS, micro_unroll=4,
                 diag_rows=8, eager=True)
    f32_err = _f32_compare(
        rk, f"phase 11b f32/bf16 segments vs plain (graphed == eager bit for "
        f"bit): funnel({D}) as a user's target, C={C} m={MAIN_M} "
        f"min_per_chain micro_unroll=4", a, b,
        dict(rtol=1e-4, atol=1e-3, slab_rtol=2.0 ** -7))

    # ms per period: the graphed segments, the eager segments, the fused
    # funnel kernel, the twin, in turns from the same banks; then the
    # split of a period, graphed and eager
    fused_tgt = tw.targets.funnel(D, generated=tw.targets.omega_sumsq)
    st0 = mk.init_state(warm.qc, warm.h_cur, warm.delta_cur, target=user,
                        cfg=cfg, warmup=None, num_iter=EXT_ITERS,
                        diag_rows=8)
    spec = rk.RoundSpec(target=user, cfg=cfg, warmup=None,
                        stop_mode="min_per_chain", num_iter=EXT_ITERS,
                        micro_unroll=4, seed=13)
    eager = functools.partial(rk._launch, graph=False)
    runs = {"graphed": (rk.run_rounds, spec), "eager": (eager, spec),
            "fused": (rk.run_rounds, spec._replace(target=fused_tgt)),
            "plain": (rk.run_rounds_plain, spec)}

    def timed(name, periods):
        fn, sp = runs[name]
        banks = rk.pack(st0)
        fn(banks, 0, sp)  # warm the path (the graphed one: its capture)
        for dst, src in zip(banks, rk.pack(st0)):
            dst.copy_(src)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for i in range(periods):
            fn(banks, i * mk.FLUSH_EVERY, sp)
        e1.record()
        torch.cuda.synchronize()
        rk.release_graphs()
        return e0.elapsed_time(e1) / periods, banks

    times = {k: [] for k in runs}
    for name in ("graphed", "eager", "fused", "plain", "plain", "fused",
                 "eager", "graphed"):
        t_ms, banks = timed(name, 2 if name == "plain" else 16)
        times[name].append(t_ms)
        if name == "graphed":
            after = banks
    ms = {k: min(v) for k, v in times.items()}

    from torch.profiler import ProfilerActivity, profile
    n_prof = 8
    split = {}
    for name in ("graphed", "eager"):
        fn, sp = runs[name]
        banks = rk.pack(st0)
        fn(banks, 0, sp)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n_prof):
                fn(banks, (i + 1) * mk.FLUSH_EVERY, sp)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n_prof
        rk.release_graphs()
        split[name] = _period_split(prof, n_prof, wall)
    rk.launches, rk.segment_launches = counted

    points = mk.FLUSH_EVERY * 4
    isz = after.vx.element_size()
    exchange = points * (4 * C * D + 2 * C) * isz  # query, g: w+r; lp: w+r
    bound = _bound(rk, rk.pack(st0), after, 16, None, extra_bytes=exchange)
    log(f"phase 11b timing, funnel({D}) as a user's target, C={C} "
        f"m={MAIN_M} f32 micro_unroll=4, 256 rounds from phase 4's chains "
        f"(CUDA events, best of 2): graphed segments {ms['graphed']:.4f} ms "
        f"per 16-round period ({[round(x, 4) for x in times['graphed']]}), "
        f"eager segments {ms['eager']:.4f} ms "
        f"({[round(x, 4) for x in times['eager']]}), the fused funnel "
        f"kernel {ms['fused']:.4f} ms "
        f"({[round(x, 4) for x in times['fused']]}), the plain twin "
        f"{ms['plain']:.3f} ms ({[round(x, 3) for x in times['plain']]}); "
        f"bound {bound[0]:.4f} ms ({bound[1]}: {bound[2]}), graphed at "
        f"{bound[0] / ms['graphed']:.1%} of it, eager at "
        f"{bound[0] / ms['eager']:.1%}; on {CARD}")
    for name, sp in split.items():
        log(f"phase 11b split of a period, {name}, under torch.profiler "
            f"({n_prof} periods): {_split_text(sp)}; against the "
            f"{ms[name]:.4f} ms period by CUDA events the card idles "
            f"{max(0.0, 1 - sp['busy_ms'] / ms[name]):.1%}")

    return dict(launches=launches, max_abs_err=f32_err, ms=ms["graphed"],
                plain_ms=ms["plain"], bound_ms=bound[0], bound_by=bound[1],
                regs=attrs["regs"], warps_per_sm=attrs["warps_per_sm"])


def _period_split(prof, periods, wall):
    """A profiled run of ``periods`` external-gradient periods, per
    period, from the profiler's device time by kernel name: the
    micro-step segments (``round_kernel_micro``), the round-boundary
    segments (``round_kernel``: the first, the last, and each that ends
    a round) and torch's kernels (the gradient's, and the round base's
    fill), each with its count and ms (and mean us for the segments),
    and the card's idle share of ``wall`` (host ms per period)."""
    import torch

    out = dict(wall_ms=wall)
    kinds = {"micro": [0, 0.0], "boundary": [0, 0.0], "torch": [0, 0.0]}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("micro" if "round_kernel_micro" in e.key else
                "boundary" if "round_kernel" in e.key else "torch")
        kinds[kind][0] += e.count
        kinds[kind][1] += e.self_device_time_total
    for kind, (n, us) in kinds.items():
        out.update({f"{kind}_n": n / periods, f"{kind}_ms": us / 1e3 / periods})
        if kind != "torch":
            out[f"{kind}_us"] = us / n if n else 0.0
    busy = out["micro_ms"] + out["boundary_ms"] + out["torch_ms"]
    out["busy_ms"] = busy
    out["idle"] = max(0.0, 1 - busy / wall)
    return out


def _split_text(sp):
    return (f"wall {sp['wall_ms']:.4f} ms per period, of which "
            f"{sp['micro_n']:.0f} micro-step segments {sp['micro_ms']:.4f} "
            f"ms ({sp['micro_us']:.2f} us each), {sp['boundary_n']:.0f} "
            f"round-boundary segments {sp['boundary_ms']:.4f} ms "
            f"({sp['boundary_us']:.2f} us each), torch's kernels "
            f"{sp['torch_ms']:.4f} ms ({sp['torch_n']:.0f} kernels); the "
            f"card busy {sp['busy_ms']:.4f} ms, idle {sp['idle']:.1%} of "
            f"this wall")


# Phase 12: the d = 2048 row of the port's gaussian-transient harness at
# the JAX artifact's stamp (1024 chains, float32, 31 iterations), then
# the same row in float64 at 50 chains over 4 iterations, card vs CPU.
GT_DIM, GT_CHAINS, GT_ITERS = 2048, 1024, 31
GT_F64_CHAINS, GT_F64_ITERS = 50, 4


def _jax_transient_row(d):
    """The JAX harness's committed row at ``d``
    (examples/out_gaussian_transient.json)."""
    rows = json.loads((HERE / "examples" / "out_gaussian_transient.json")
                      .read_text())["rows"]
    return next(r for r in rows if r["d"] == d)


def phase_examples(rk, dev):
    """12: the port's gaussian-transient harness (``walnuts_tpu_torch.
    examples.gaussian_transient``; the scan engine, plain torch, no
    hand-written kernel).  (a) its ``run_row`` at d = ``GT_DIM`` and the
    JAX artifact's stamp: the harness's gate (every arm >= 95% of chains
    inside the chi-square band within the iterations) must pass; each
    arm's iterations to 95% beside the JAX artifact's, its s per
    transition, and the round kernel's launches over the row (0).  (b)
    each arm's run in float64 at ``GT_F64_CHAINS`` chains over
    ``GT_F64_ITERS`` iterations on the card against the CPU: integer
    diagnostics equal, everything within EXACT."""
    import torch
    from walnuts_tpu_torch.examples import gaussian_transient as gt
    from walnuts_tpu_torch.utils.parity import EXACT

    jax_row = _jax_transient_row(GT_DIM)
    rk.launches = rk.segment_launches = 0
    t0 = time.perf_counter()
    row = gt.run_row(GT_DIM, chains=GT_CHAINS, iters=GT_ITERS,
                     dtype=torch.float32, device=dev, log=lambda s: None)
    wall = time.perf_counter() - t0
    launches = rk.launches + rk.segment_launches
    for tag, _, _ in gt.ARMS:
        r = row[tag]
        log(f"phase 12a gaussian_transient d={GT_DIM} C={GT_CHAINS} f32 "
            f"{tag}: iters to 95% inside {r['iters_to_95pct_inside']} "
            f"(JAX artifact {jax_row[tag]['iters_to_95pct_inside']}); "
            f"{r['seconds']:.2f} s = {r['s_per_transition']:.4f} s per "
            f"transition; the slowest chain's grad evals per transition "
            f"{r['grad_evals_max_chain_per_transition']:.1f}; final "
            f"fraction inside {r['frac_inside_by_iter'][-1]:.4f}")
    failed = [tag for tag, _, _ in gt.ARMS
              if not gt.passed(row[tag]["iters_to_95pct_inside"], GT_ITERS)]
    if failed:
        raise AssertionError(f"12a: {failed} missed the chi-square band "
                             f"within {GT_ITERS} iterations")
    if launches:
        raise AssertionError(f"12a: {launches} round-kernel launches")
    log(f"phase 12a gate passed: every arm >= 95% inside within "
        f"{GT_ITERS} iterations; row wall {wall:.2f} s; round-kernel "
        f"launches {launches}")

    int_cols = SCAN_INT_COLS
    errs = {}
    t0 = time.perf_counter()
    for tag, _, _ in gt.ARMS:
        kw = dict(chains=GT_F64_CHAINS, iters=GT_F64_ITERS,
                  dtype=torch.float64)
        s_g, d_g, _ = gt.run_arm(GT_DIM, tag, device=dev, **kw)
        s_c, d_c, _ = gt.run_arm(GT_DIM, tag, device="cpu", **kw)
        if s_g.device.type != torch.device(dev).type:
            raise AssertionError("12b: the harness did not run on the card")
        errs[tag] = max(_assert_same(f"12b {tag} sum q^2", s_c, s_g, EXACT),
                        _assert_same(f"12b {tag} diagnostics", d_c, d_g,
                                     EXACT, int_cols))
    log(f"phase 12b gaussian_transient d={GT_DIM} f64 C={GT_F64_CHAINS}, "
        f"{GT_F64_ITERS} iterations, card == CPU for every arm: integer "
        f"diagnostics equal, max abs diff "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (rtol "
        f"{EXACT['rtol']:g}, atol {EXACT['atol']:g}); "
        f"{time.perf_counter() - t0:.2f} s")


# Phase 13: (a) the d = 2^GE_LOG2D program of the port's gaussian_ess
# harness at its chains_for batch for GE_ITERS transitions per arm (the
# harness's default is 1000); (b) highdim_variants' im_std arm at its
# full width for HD_ITERS transitions in chunks of HD_CHUNK (400 in
# chunks of 50 by default); (c) its im_illcond and iso_illcond arms at
# D = HD_F64_DIM, float64, card against CPU.
GE_LOG2D, GE_CHAINS, GE_ITERS = 10, 64, 25
HD_DIM, HD_CHAINS, HD_ITERS, HD_CHUNK = 10000, 32, 20, 10
HD_F64_DIM, HD_F64_CHAINS, HD_F64_ITERS, HD_F64_CHUNK = 16, 8, 2, 1


def _jax_ess_row(d):
    """The JAX harness's committed row at ``d``
    (examples/out_gaussian_ess.json)."""
    rows = json.loads((HERE / "examples" / "out_gaussian_ess.json")
                      .read_text())["rows"]
    return next(r for r in rows if r["d"] == d)


def phase_last_examples(rk, dev):
    """13: the port's gaussian_ess and highdim_variants harnesses
    (``walnuts_tpu_torch.examples``; the scan engine and generic NUTS,
    plain torch, no hand-written kernel).  (a) ``gaussian_ess.run_one``
    at d = 2^``GE_LOG2D`` for each arm: ESS per 1000 gradient
    evaluations of q_0 and sum q^2 beside the JAX artifact's row, finite
    and positive, and 0 round-kernel launches.  (b) ``highdim_variants``'
    ``im_std`` arm at D = ``HD_DIM``, ``HD_CHAINS`` chains: its z-scores
    behind the harness's gate (every |z| < 4), its s per transition and
    the implicit midpoint's fixed-point host syncs per transition.  (c)
    the ``im_illcond`` and ``iso_illcond`` arms at D = ``HD_F64_DIM`` in
    float64 on the card against the CPU: integer diagnostics equal,
    everything within EXACT."""
    import math
    import torch
    from walnuts_tpu_torch.examples import gaussian_ess as ge
    from walnuts_tpu_torch.examples import highdim_variants as hv
    from walnuts_tpu_torch.utils.parity import EXACT

    d = 2 ** GE_LOG2D
    jax_row = _jax_ess_row(d)
    rk.launches = rk.segment_launches = 0
    t0 = time.perf_counter()
    for integ, tag in ge.INTEGRATORS:
        r = ge.run_one(GE_LOG2D, integ, GE_CHAINS, GE_ITERS, device=dev)
        effs = [r["ess_per_1000_grad_q0"], r["ess_per_1000_grad_sumsq"]]
        if not all(math.isfinite(e) and e > 0 for e in effs):
            raise AssertionError(f"13a {tag}: ESS per 1000 grads {effs}")
        log(f"phase 13a gaussian_ess d={d} C={r['chains']} f32 {tag}, "
            f"{GE_ITERS} transitions: ESS per 1000 grads (q0, sum q^2) "
            f"{effs[0]:.2f}, {effs[1]:.2f} (JAX artifact, 1000 "
            f"transitions: {jax_row[tag]['ess_per_1000_grad_q0']:.2f}, "
            f"{jax_row[tag]['ess_per_1000_grad_sumsq']:.2f}); "
            f"{r['s_per_transition']:.4f} s per transition; the slowest "
            f"chain's grad evals per transition "
            f"{r['grad_evals_max_chain_per_transition']:.1f}; peak "
            f"{r.get('peak_memory_bytes', 0) / 2 ** 20:.1f} MiB")
    launches = rk.launches + rk.segment_launches
    if launches:
        raise AssertionError(f"13a: {launches} round-kernel launches")
    log(f"phase 13a: {time.perf_counter() - t0:.2f} s; round-kernel "
        f"launches {launches}")

    r = hv.run_arm("im_std", dim=HD_DIM, chains=HD_CHAINS, iters=HD_ITERS,
                   chunk=HD_CHUNK, device=dev)
    z = {k: round(r[k], 3) for k in ("z_mean_q0", "z_mean_qlast",
                                     "z_radius_sq")}
    log(f"phase 13b highdim_variants im_std D={HD_DIM} C={HD_CHAINS} f32, "
        f"{HD_ITERS} transitions in chunks of {HD_CHUNK}: z {z}; "
        f"{r['s_per_transition']:.4f} s per transition; "
        f"{r['grad_evals_per_s']:.1f} grad-evals/s; the slowest chain's "
        f"grad evals per transition "
        f"{r['grad_evals_max_chain_per_transition']:.1f}; fixed-point host "
        f"syncs per transition {r['fixed_point_syncs_per_transition']:.1f}; "
        f"radius mean {r['radius_sq_mean']:.1f} against {HD_DIM}; "
        f"round-kernel launches {rk.launches + rk.segment_launches}")
    if not hv.max_abs_z(r) < hv.Z_GATE:
        raise AssertionError(f"13b: |z| {hv.max_abs_z(r):.3f} >= "
                             f"{hv.Z_GATE}")

    t0 = time.perf_counter()
    int_cols = {"im": SCAN_INT_COLS, "iso": GENERIC_INT_COLS}
    for arm in ("im_illcond", "iso_illcond"):
        q0 = hv.start(arm, HD_F64_CHAINS, HD_F64_DIM, torch.float64)
        kw = dict(iters=HD_F64_ITERS, chunk=HD_F64_CHUNK)
        s_g, d_g, _, _, syncs = hv.sample(arm, q0, device=dev, **kw)
        s_c, d_c, _, _, _ = hv.sample(arm, q0, device="cpu", **kw)
        cols = int_cols[arm.split("_")[0]]
        err = max(_assert_same(f"13c {arm} draws", s_c, s_g, EXACT),
                  _assert_same(f"13c {arm} diagnostics", d_c, d_g, EXACT,
                               cols))
        log(f"phase 13c highdim_variants {arm} D={HD_F64_DIM} "
            f"C={HD_F64_CHAINS} f64, {HD_F64_ITERS} iterations, card == "
            f"CPU: integer diagnostics equal, max abs diff {err:.3e} (rtol "
            f"{EXACT['rtol']:g}, atol {EXACT['atol']:g})"
            + (f"; fixed-point host syncs {syncs}" if arm.startswith("im_")
               else ""))
    log(f"phase 13c: {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 14: the round kernel's posterior at the JAX tests' configurations
# ---------------------------------------------------------------------------

# Threads of each of phase 14's two CPU processes (the scan engine's side
# of its comparisons); the card's runs go on meanwhile in this process.
STATS_CPU_THREADS = 3


def _stats_scan_run(job):
    """One of phase 14's scan-engine runs, on the host CPU in a process of
    its own (``run_walnuts(..., device="cpu")``): ``"gauss"``,
    ``tests/test_megakernel.py:26-29``'s fixed-tuning run (its
    diagnostics), or ``"warmup"``, ``:85-87``'s warmup run (its adapted
    H and delta)."""
    import torch
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch.utils import threefry

    torch.set_num_threads(STATS_CPU_THREADS)
    t0 = time.perf_counter()
    if job == "gauss":
        q0 = threefry.normal(threefry.PRNGKey(1), (128, 10), torch.float64)
        wu = tw.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
        _, d, _ = tw.run_walnuts(
            11, q0, target=tw.targets.std_gauss(10),
            cfg=tw.WalnutsConfig(m=6), warmup=wu, num_iter=400, h0=0.5,
            delta0=0.1, device="cpu")
        out = dict(diags=d.numpy())
    else:
        q0 = 0.1 * threefry.normal(threefry.PRNGKey(3), (128, 11),
                                   torch.float64)
        _, _, st = tw.run_walnuts(
            8, q0, target=tw.targets.funnel(11), cfg=tw.WalnutsConfig(m=6),
            warmup=tw.WarmupConfig(warmup_iter=100), num_iter=100, h0=0.3,
            delta0=0.3, device="cpu")
        out = dict(h=st.h.numpy(), delta=st.delta.numpy())
    out["wall"] = time.perf_counter() - t0
    return out


def start_stats_scans():
    """Start phase 14's two scan-engine runs on the host CPU, in two
    processes that run while phase 13 and phase 14's card runs go on;
    returns the pool and the futures (``phase_stats`` shuts the pool)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    return pool, {j: pool.submit(_stats_scan_run, j)
                  for j in ("gauss", "warmup")}


def phase_stats(rk, dev, scans):
    """14: the fused engine's statistical tests of the JAX package
    (``tests/test_megakernel.py``, ``tests/test_float32.py``) through
    ``run_walnuts_fused`` on the card, at their sizes, starting points
    (``PRNGKey(seed)`` through threefry), hash seeds (``key_hash_seed``)
    and gates: (a) funnel(11)'s omega marginal, f64; (b) std_gauss(10)'s
    moments and its orbit geometry against the scan engine at the same
    seed; (c) ``micro_unroll`` 1 against 4 on funnel(8): moments,
    gradients per transition within 10%, geometry; (d) float32 with the
    bf16 slab against the engine's own float64 run; (e) in-loop warmup
    against the scan engine's adaptation; (f) the pooled consensus.  The
    scan engine's two runs (``scans``, from :func:`start_stats_scans`) go
    on the host CPU in two processes while the card runs.  Every run must
    launch the kernel; every gate prints its statistic, bound, launches
    and wall, and a miss fails the phase."""
    import numpy as np
    import torch
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch.sampler.megakernel import key_hash_seed
    from walnuts_tpu_torch.utils import threefry

    t_phase = time.perf_counter()
    misses = []

    def normal(seed, shape, dtype=torch.float64):
        return threefry.normal(threefry.PRNGKey(seed), shape, dtype)

    def fused(tag, key, q0, h, dl, target, m, num_iter, **kw):
        C = q0.shape[0]
        rk.launches = rk.segment_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tw.run_walnuts_fused(
            key_hash_seed(key), q0, torch.full((C,), h, dtype=q0.dtype),
            torch.full((C,), dl, dtype=q0.dtype), target=target,
            cfg=tw.WalnutsConfig(m=m), num_iter=num_iter, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rk.launches <= 0 or rk.segment_launches:
            raise AssertionError(f"14{tag}: {rk.launches} fused launches, "
                                 f"{rk.segment_launches} segment launches")
        out = tuple(x.cpu().numpy() if torch.is_tensor(x) else x
                    for x in out)
        return out, rk.launches, wall

    def gate(tag, name, stat, bound, run):
        ok = bool(abs(stat) < bound)
        log(f"phase 14{tag} {name}: {stat:.6g} against {bound:.6g} "
            f"{'pass' if ok else 'MISS'} (launches {run[0]}, wall "
            f"{run[1]:.2f} s)")
        if not ok:
            misses.append(f"14{tag} {name}")

    pool, jobs = scans
    with pool:
        # (a) tests/test_megakernel.py:39-53
        (s, _, _, _, _), n, wall = fused(
            "a", 5, 0.1 * normal(0, (128, 11)), 0.32, 0.34,
            tw.targets.funnel(11), 7, 600)
        w = s[150:, :, 0].ravel()
        n_eff = len(w) / 50
        gate("a", "funnel(11) C=128 f64 omega mean", w.mean(),
             5 * 3 / np.sqrt(n_eff), (n, wall))
        gate("a", "omega sd - 3", w.std() - 3.0,
             5 * 3 * np.sqrt(0.5 / n_eff), (n, wall))

        # (b) tests/test_megakernel.py:12-36, the fused side
        (s, d_f, _, _, _), n, wall = fused(
            "b", 11, normal(1, (128, 10)), 0.5, 0.1, tw.targets.std_gauss(10),
            6, 400)
        x = s[100:]
        n_eff = x.shape[0] * x.shape[1] / 8
        run_b = (n, wall)
        gate("b", "std_gauss(10) C=128 f64 mean", x.mean(),
             5 / np.sqrt(n_eff), run_b)
        gate("b", "sd - 1", x.std() - 1.0, 5 * np.sqrt(0.5 / n_eff), run_b)

        # (c) tests/test_megakernel.py:282-311
        outs = {}
        for K in (1, 4):
            (s, d, _, _, ng), n, wall = fused(
                "c", 12, 0.1 * normal(4, (256, 8)), 0.4, 0.3,
                tw.targets.funnel(8), 6, 300, micro_unroll=K)
            outs[K] = (s[100:], d, float(ng), (n, wall))
            log(f"phase 14c funnel(8) C=256 f64 micro_unroll={K}: "
                f"{float(ng) / (300 * 256):.3f} grads per transition, "
                f"launches {n}, wall {wall:.2f} s")
        run_c = tuple(a + b for a, b in zip(outs[1][3], outs[4][3]))
        w1, w4 = outs[1][0][..., 0], outs[4][0][..., 0]
        se = 3.0 * np.sqrt(2.0 / (w1.size / 20))
        gate("c", "omega mean K=1 - K=4", w1.mean() - w4.mean(), 5 * se,
             run_c)
        gate("c", "omega sd K=1 - K=4", w1.std() - w4.std(), 5 * se, run_c)
        g1, g4 = (outs[K][2] / (300 * 256) for K in (1, 4))
        gate("c", "grads per transition (K=1 - K=4) / K=1",
             (g1 - g4) / g1, 0.1, run_c)
        for col in (1, 8, 9, 21, 22):
            m1, m4 = (outs[K][1][..., col].mean() for K in (1, 4))
            gate("c", f"diagnostic column {col} mean K=1 - K=4", m1 - m4,
                 0.25 + 0.05 * abs(m1), run_c)

        # (d) tests/test_float32.py:44-74
        q64 = 0.1 * normal(2, (128, 11))
        res = {}
        for tag, q0 in (("f64", q64), ("f32", q64.float())):
            (s, d, _, _, _), n, wall = fused("d", 5, q0, 0.32, 0.34,
                                             tw.targets.funnel(11), 7, 600)
            w = s.astype(np.float64)[150:, :, 0].ravel()
            res[tag] = (w.mean(), w.std(), d.astype(np.float64), (n, wall))
        run_d = tuple(a + b for a, b in zip(res["f64"][3], res["f32"][3]))
        n_eff = 128 * 450 / 50
        gate("d", "funnel(11) C=128 omega mean f32 - f64",
             res["f32"][0] - res["f64"][0], 7 * 3 / np.sqrt(n_eff), run_d)
        gate("d", "omega sd f32 - f64", res["f32"][1] - res["f64"][1],
             7 * 3 * np.sqrt(0.5 / n_eff), run_d)
        e32, e64 = (res[k][2][..., 17].ravel() for k in ("f32", "f64"))
        m32 = np.median(e32[np.isfinite(e32)])
        m64 = np.median(e64[np.isfinite(e64)])
        gate("d", "median orbit energy error f32 - f64", m32 - m64,
             0.15 * max(m64, 0.05), run_d)

        # (e) tests/test_megakernel.py:69-102, the fused side
        out, n, wall = fused(
            "e", 7, 0.1 * normal(3, (128, 11)), 0.3, 0.3,
            tw.targets.funnel(11), 6, 100,
            warmup=tw.WarmupConfig(warmup_iter=100))
        d_e, h_mk, dl_mk = out[1], out[5], out[6]
        run_e = (n, wall)

        # (f) tests/test_megakernel.py:105-121
        out, n, wall = fused(
            "f", 9, normal(0, (64, 8)), 0.4, 0.2, tw.targets.std_gauss(8), 5,
            60, warmup=tw.WarmupConfig(warmup_iter=60, pooled=True))
        h_f, dl_f = out[5], out[6]
        if not (np.all(np.isfinite(h_f)) and np.all(h_f > 0)):
            misses.append("14f H finite and positive")
        gate("f", "std_gauss(8) C=64 pooled: ptp(H) / median(H)",
             np.ptp(h_f) / np.median(h_f), 1e-6, (n, wall))
        gate("f", "ptp(delta) / median(delta)",
             np.ptp(dl_f) / np.median(dl_f), 1e-6, (n, wall))

        scan = {j: f.result() for j, f in jobs.items()}

    # (b) the scan side: orbit geometry as the JAX test compares it
    d_s = scan["gauss"]["diags"]
    log(f"phase 14b scan engine on the host CPU, 400 transitions: "
        f"{scan['gauss']['wall']:.2f} s")
    for col in (1, 20, 9, 8, 21, 22):
        gate("b", f"diagnostic column {col} mean fused - scan",
             d_f[..., col].mean() - d_s[..., col].mean(), 0.1, run_b)
    for code, bound in ((4, 0.05), (5, 0.02)):
        gate("b", f"stop code {code} share fused - scan",
             (d_f[..., 19] == code).mean() - (d_s[..., 19] == code).mean(),
             bound, run_b)
    gate("b", "grad count (column 6) mean fused - scan",
         d_f[..., 6].mean() - d_s[..., 6].mean(), 1.0, run_b)

    # (e) the scan side
    log(f"phase 14e scan engine warmup on the host CPU, 100 transitions: "
        f"{scan['warmup']['wall']:.2f} s")
    h_mk, h_sc = (float(np.median(x)) for x in (h_mk, scan["warmup"]["h"]))
    d_mk, d_sc = (float(np.median(x)) for x in (dl_mk,
                                               scan["warmup"]["delta"]))
    gate("e", "funnel(11) C=128 log(median H fused / scan)",
         np.log(h_mk / h_sc), 0.5, run_e)
    gate("e", "log(median delta fused / scan)", np.log(d_mk / d_sc), 0.7,
         run_e)
    moved_mk, moved_sc = np.log(h_mk / 0.3), np.log(h_sc / 0.3)
    if not (abs(moved_sc) > 0.02 and abs(moved_mk) > 0.02
            and np.sign(moved_mk) == np.sign(moved_sc)):
        misses.append("14e adaptation moved H the same way")
    log(f"phase 14e log(H / 0.3): fused {moved_mk:.4f}, scan "
        f"{moved_sc:.4f} (each past 0.02, same sign)")
    if not np.all(d_e[..., 18] > 0):
        misses.append("14e delta (column 18) positive")

    log(f"phase 14: {time.perf_counter() - t_phase:.2f} s")
    if misses:
        raise AssertionError(f"phase 14 missed: {misses}")


def _counts(x):
    vals, counts = x.unique(return_counts=True)
    return {int(v): int(c) for v, c in zip(vals.tolist(), counts.tolist())}


if __name__ == "__main__":
    main()
