"""Time the first transitions of each run in ``tests/test_torch_stats_gpu.py``
on the card, to project what the whole case costs there; optionally run
chip_smoke's phase 14 alone first.

Each head runs in a process of its own, all at once (as
``scripts/run_stats_gpu.sh`` runs the cases), and prints one JSON line:
the case, the transitions run, the wall and the wall per transition.
Run from the repository root on a machine with one CUDA card:

    python scripts/probe_stats_heads.py [--phase14] [--only NAME ...]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# each case's head: transitions (or iterations) to time
HEADS = {"scan_funnel11_f64": 30, "scan_funnel11_f32": 30,
         "deep_neck_f32": 3, "generic_hmc": 20, "multi_iso": 20, "im": 4,
         "pseudo_funnel": 6}


def head(name, n):
    """The first ``n`` transitions of case ``name``'s run on the card."""
    import torch
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch import sampler as sp
    from walnuts_tpu_torch import targets
    from walnuts_tpu_torch.utils import threefry

    dev = torch.device("cuda")

    def normal(seed, shape, dtype=torch.float64):
        return threefry.normal(threefry.PRNGKey(seed), shape, dtype)

    runs = {
        "scan_funnel11_f64": lambda: tw.run_walnuts(
            4, 0.1 * normal(3, (128, 11)), target=targets.funnel(11),
            cfg=tw.WalnutsConfig(m=8),
            warmup=tw.WarmupConfig(warmup_iter=500), num_iter=n, h0=0.3,
            delta0=0.3, device=dev),
        "scan_funnel11_f32": lambda: tw.run_walnuts(
            1, 0.1 * normal(0, (256, 11), torch.float32),
            target=targets.funnel(11), cfg=tw.WalnutsConfig(m=8),
            warmup=tw.WarmupConfig(warmup_iter=300, pooled=True),
            num_iter=n, h0=0.3, delta0=0.3, device=dev),
        "deep_neck_f32": lambda: tw.run_walnuts(
            4, torch.zeros((64, 11), dtype=torch.float32).index_fill_(
                1, torch.tensor([0]), -10.0)
            + 0.01 * normal(3, (64, 11), torch.float32),
            target=targets.funnel(11),
            cfg=tw.WalnutsConfig(m=8, igr=tw.IntegratorConfig(max_c=16)),
            warmup=tw.WarmupConfig(warmup_iter=0, adapt_h=False,
                                   adapt_delta=False),
            num_iter=n, h0=0.3, delta0=0.3, device=dev),
        "generic_hmc": lambda: sp.run_generic_nuts(
            5, 0.2 * normal(4, (64, 6)), target=targets.funnel(6),
            kernel=sp.HMCKernel(), h_macro=0.4, delta=0.3, num_iter=n, m=7,
            device=dev),
        "multi_iso": lambda: sp.run_multinomial(
            3, 0.2 * normal(2, (64, 2)), target=targets.corr_gauss(0.95),
            kernel=sp.IsokineticKernel(),
            cfg=sp.MultinomialConfig(l_orbit=32), h0=0.3, delta0=0.2,
            num_iter=n, warmup_iter=150, device=dev),
        "im": lambda: tw.run_walnuts(
            1, 0.1 * normal(0, (32, 4)), target=targets.std_gauss(4),
            cfg=tw.WalnutsConfig(m=5,
                                 integrator="adapt_implicit_midpoint_d"),
            warmup=tw.WarmupConfig(warmup_iter=100), num_iter=n, h0=0.5,
            delta0=0.1, device=dev),
        "pseudo_funnel": lambda: sp.walnuts_pseudo(
            9, torch.zeros((64, 6), dtype=torch.float64).index_fill_(
                1, torch.tensor([0]), 0.5),
            target=targets.funnel(6),
            inv_mass=torch.ones(6, dtype=torch.float64), macro_step=0.5,
            max_depth=9, max_error=0.2, iter_warmup=0, iter_sample=n,
            device=dev),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs[name]()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(json.dumps({"probe": name, "iters": n, "s": round(dt, 3),
                      "s_per_iter": round(dt / n, 4)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase14", action="store_true",
                    help="build the kernel and run chip_smoke phase 14 "
                         "alone first")
    ap.add_argument("--only", nargs="+", choices=sorted(HEADS),
                    default=sorted(HEADS))
    ap.add_argument("--head", nargs=2, metavar=("NAME", "N"),
                    help=argparse.SUPPRESS)      # one head, in a child
    args = ap.parse_args(argv)
    if args.head:
        head(args.head[0], int(args.head[1]))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_stats_heads: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if args.phase14:
        import chip_smoke as cs
        from walnuts_tpu_torch import _build
        from walnuts_tpu_torch.sampler import round_kernel as rk

        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        cs.phase_build(_build, rk)
        t0 = time.perf_counter()
        cs.phase_stats(rk, dev, cs.start_stats_scans())
        print(f"phase 14 alone: {time.perf_counter() - t0:.2f} s", flush=True)
    procs = [subprocess.Popen([sys.executable, __file__, "--head", k,
                               str(HEADS[k])]) for k in args.only]
    for p in procs:
        p.wait(timeout=1800)


if __name__ == "__main__":
    main()
