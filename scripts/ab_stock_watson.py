#!/usr/bin/env python3
"""Run the round kernel's Stock-Watson instantiation at ``chip_smoke.py``
phase 9b's shape from several checkouts in turn on one card, to compare
them within one call: the proper model over the 252 quarters (D = 756),
256 chains, m = 10, the walnuts_d arm's protocol (``adapt_leapfrog_d``,
min_c = 3), float32 with the bf16 slab, ``min_per_chain``,
``micro_unroll=1``, fixed step size 0.1 and delta 0.3, from fixed chains
(the mode by Adam, as phase 9, plus 0.5-sd jitter from a seeded
generator).

    python3 scripts/ab_stock_watson.py DIR [DIR ...]

Each DIR is a checkout of the repo, such as the parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists; list
each more than once, alternating (parent, change, change, parent).
Each run is a fresh process in DIR that builds the kernel and reports:

- ``ms``: kernel ms per 16-round launch by CUDA events over 16 launches
  from the same start, queued behind a device sleep so that the events
  time the kernels back to back and not the host's ``run_rounds``
  calls, best of two (``ms_runs`` both);
- ``bound_ms``, ``share``: the checkout's ``chip_smoke._bound`` over
  those launches and ``bound_ms / ms``;
- ``twin_equal``: the fraction of chains whose integer banks equal the
  plain twin's after one launch from the start, and ``twin_max_abs``
  the largest finite float difference from the twin on those chains
  (scalar rows and vectors);
- ``wall_ms``: wall ms per launch of ``run_walnuts_fused`` over 64
  launches from the start (the host loop's sync and launch included,
  as phase 9b pays them), best of two;
- ``gauss``: the same kernel timing for std_gauss(756) from 256 chains
  of 0.5-sd jitter with the same config (the round body with a trivial
  gradient); ``ns_per_grad`` for both targets is kernel ns per launch
  over the gradient evaluations the launch made;
- ``attrs``: the instantiation's registers, local bytes, warps per SM
  and, where the checkout reports them, its threads per block and
  warps per chain.

The runs' output goes to standard error; standard output gets the
card's name and power limit, then one JSON line per run.
"""

import json
import subprocess
import sys

RUN = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import walnuts_tpu_torch as tw
from walnuts_tpu_torch import _build
from walnuts_tpu_torch.sampler import megakernel as mk
from walnuts_tpu_torch.sampler import round_kernel as rk

dev = torch.device("cuda:0")
torch.cuda.set_device(dev)
_build.load()
C = cs.SW_CHAINS
cfg = tw.WalnutsConfig(m=cs.SW_M, integrator="adapt_leapfrog_d",
                       igr=tw.IntegratorConfig(min_c=3))
sw = tw.targets.stock_watson(proper=True)
D = sw.dim
mode, _ = cs._sw_find_mode(sw, dev)
g = torch.Generator(device=dev).manual_seed(0)
q_sw = mode[None] + 0.5 * torch.randn(C, D, generator=g, device=dev)
q_gauss = 0.5 * torch.randn(C, D, generator=g, device=dev)
h = torch.full((C,), cs.SW_H0, device=dev)
dl = torch.full((C,), cs.SW_DELTA0, device=dev)


def kernel_time(target, q0, seed):
    st0 = mk.init_state(q0, h, dl, target=target, cfg=cfg, warmup=None,
                        num_iter=cs.SW_ITERS, diag_rows=8)
    spec = rk.RoundSpec(target=target, cfg=cfg, warmup=None,
                        stop_mode="min_per_chain", num_iter=cs.SW_ITERS,
                        micro_unroll=1, seed=seed)
    runs = []
    for _ in range(2):
        banks = rk.pack(st0)
        rk.run_rounds(banks, 0, spec)  # warm the path
        banks = rk.pack(st0)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)  # ~25 ms
        e0.record()
        for i in range(16):
            rk.run_rounds(banks, i * mk.FLUSH_EVERY, spec)
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / 16)
    gc = rk.I_FIELDS.index("grad_ct")
    grads = int((banks.si[gc].long() - rk.pack(st0).si[gc].long()).sum()) / 16
    ms = min(runs)
    out = dict(ms=ms, ms_runs=runs, grads_per_launch=grads,
               ns_per_grad=ms * 1e6 / grads)
    return out, st0, spec, banks


out = {}
out["sw"], st0, spec, after = kernel_time(sw, q_sw, 23)
bound = cs._bound(rk, rk.pack(st0), after, 16, None, cs.SW_FLOPS_PER_COORD)
out["sw"].update(bound_ms=bound[0], bound_by=bound[1],
                 share=bound[0] / out["sw"]["ms"], bound_detail=bound[2])
a, b = rk.pack(st0), rk.pack(st0)
rk.run_rounds(a, 0, spec)
rk.run_rounds_plain(b, 0, spec)
torch.cuda.synchronize()
agree = (a.si == b.si).all(0)
out["sw"]["twin_equal"] = float(agree.float().mean())
diff = torch.cat([(x[..., agree] - y[..., agree]).abs().flatten()
                  for x, y in ((a.sf, b.sf), (a.vx.transpose(0, 2),
                                              b.vx.transpose(0, 2)))])
out["sw"]["twin_max_abs"] = float(diff[torch.isfinite(diff)].max())
out["gauss"], *_ = kernel_time(tw.targets.std_gauss(D), q_gauss, 23)
walls = []
for _ in range(2):
    n0 = rk.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.run_walnuts_fused(23, q_sw, h, dl, target=sw, cfg=cfg,
                         num_iter=cs.SW_ITERS, stop_mode="min_per_chain",
                         rounds=64 * mk.FLUSH_EVERY, diag_rows=8, device=dev)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3 / (rk.launches - n0))
out["sw"]["wall_ms"] = min(walls)
out["sw"]["wall_runs"] = walls
out["attrs"] = rk.kernel_attributes(torch.float32, "stock_watson", D)
print("AB " + json.dumps(out))
"""


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for i, where in enumerate(sys.argv[1:]):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=where,
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode:
            raise SystemExit(f"run {i} in {where} exited {proc.returncode}")
        for line in proc.stdout.splitlines():
            if line.startswith("AB "):
                print(json.dumps(dict(run=i, dir=where,
                                      **json.loads(line[3:]))), flush=True)


if __name__ == "__main__":
    main()
