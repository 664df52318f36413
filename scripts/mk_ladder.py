"""Fused-engine throughput ladder on the card: grad-evals/s against
``micro_unroll`` K (the port of ``tools/mk_ladder.py``).

Measures the main path's configuration (funnel(101) with its (omega,
sum x^2) summary, 8192 chains, float32 with the bf16 slab, m = 8, tuning
adapted by a pooled in-loop warmup) at K in {1, 2, 4, 8}, through
``run_walnuts_fused`` in round-capped calls that resume through
``mk_state``, in ``min_per_chain`` mode with a never-reached quota.  Each
rung first makes two untimed calls, then calls for ``--seconds`` of wall
and prints one JSON line: grad-evals/s, rounds/s, gradients per round per
chain, kernel launches and wall per launch.  The seeds are the hash seeds
the JAX tool's keys give (``PRNGKey(1)`` for the warmup, ``PRNGKey(2)``
for the rungs).  The file it writes (``--out``) holds the card's name and
power limit, the configuration and every line.

Run from the repository root on a machine with one CUDA card:

    python scripts/mk_ladder.py [--chains 8192] [--seconds 20] \\
        [--out walnuts_tpu_torch/examples/out_mk_ladder.json]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card():
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: unavailable"


def emit(row, rows):
    rows.append(row)
    print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=101)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--warmup-iters", type=int, default=200)
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--rounds", type=int, default=2500)
    ap.add_argument("--out", default=str(
        ROOT / "walnuts_tpu_torch" / "examples" / "out_mk_ladder.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mk_ladder: needs a CUDA device")
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch.sampler import round_kernel as rk
    from walnuts_tpu_torch.sampler.megakernel import key_hash_seed
    from walnuts_tpu_torch.utils import threefry

    dev = torch.device("cuda")
    C, D = args.chains, args.dim
    target = tw.targets.funnel(D, generated=tw.targets.omega_sumsq)
    cfg = tw.WalnutsConfig(m=8)
    q0 = 0.3 * threefry.normal(threefry.PRNGKey(0), (C, D), torch.float32)
    h_t = torch.full((C,), 0.3, dtype=torch.float32)
    d_t = torch.full((C,), 0.3, dtype=torch.float32)
    rows = []
    stamp = dict(card=card(), torch=torch.__version__,
                 cuda=torch.version.cuda, chains=C, dim=D, m=8,
                 dtype="float32", summary="omega_sumsq",
                 warmup_iters=args.warmup_iters, rounds=args.rounds,
                 seconds=args.seconds)
    print(json.dumps(stamp), flush=True)

    # a short pooled in-loop warmup, so that every rung runs at adapted
    # tuning
    wu = tw.WarmupConfig(warmup_iter=args.warmup_iters, pooled=True)
    kw = dict(target=target, cfg=cfg, num_iter=args.warmup_iters, warmup=wu,
              ring_rows=8, rounds=args.rounds, device=dev)
    stt = None
    t0 = time.perf_counter()
    while True:
        stt = tw.run_walnuts_fused(key_hash_seed(1), q0, h_t, d_t,
                                   mk_state=stt, **kw)[-1]
        if int(stt.it.min()) >= args.warmup_iters:
            break
    q1, h_t, d_t = stt.qc, stt.h_cur, stt.delta_cur
    emit({"adapted_h_median": float(h_t.double().median()),
          "adapted_delta_median": float(d_t.double().median()),
          "warmup_seconds": round(time.perf_counter() - t0, 2)}, rows)

    seed = key_hash_seed(2)
    for K in args.ks:
        kw2 = dict(target=target, cfg=cfg, num_iter=1 << 30,
                   stop_mode="min_per_chain", ring_rows=8, diag_rows=8,
                   rounds=args.rounds, micro_unroll=K, device=dev)
        stt = None
        for _ in range(2):                       # untimed: first launches
            stt = tw.run_walnuts_fused(seed, q1, h_t, d_t, mk_state=stt,
                                       **kw2)[-1]
        torch.cuda.synchronize()
        g0 = int(stt.grad_ct.to(torch.int64).sum())
        n0, l0 = stt.n, rk.launches
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            stt = tw.run_walnuts_fused(seed, q1, h_t, d_t, mk_state=stt,
                                       **kw2)[-1]
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        g1 = int(stt.grad_ct.to(torch.int64).sum())
        rounds = max(stt.n - n0, 1)
        launches = rk.launches - l0
        emit({"K": K,
              "grad_evals_per_s": round((g1 - g0) / dt, 1),
              "rounds_per_s": round(rounds / dt, 1),
              "grads_per_round_per_chain": round((g1 - g0) / rounds / C, 4),
              "launches": launches,
              "ms_per_launch": round(1e3 * dt / max(launches, 1), 4),
              "seconds": round(dt, 2)}, rows)

    best = max((r for r in rows if "K" in r),
               key=lambda r: r["grad_evals_per_s"])
    out = dict(stamp, rows=rows, best_K=best["K"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"mk_ladder: best K = {best['K']} ({best['grad_evals_per_s']:.1f} "
          f"grad-evals/s); wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
