#!/usr/bin/env python3
"""Run one period shape of the round kernel's external-gradient route
from several checkouts in turn on one card, to compare them within one
call: funnel(101) handed over as a user's target (no fused gradient),
8192 chains, m=8, float32, ``min_per_chain``, ``micro_unroll=4`` (the
shape of ``chip_smoke.py``'s phase 11b), from fixed chains at a fixed
step size.

    python3 scripts/ab_external_segments.py DIR [DIR ...]

Each DIR is a checkout of the repo, such as the parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists; list
each more than once, alternating (parent, change, change, parent).
Each run is a fresh process in DIR that builds the kernel and, from the
same start, runs four periods through ``round_kernel.run_rounds`` and
hashes every bank after each, and each scalar row and vector after the
fourth (equal hashes: the checkouts leave the state bit for bit the
same), times 16 periods by CUDA events, and splits 8 profiled
periods into micro-step segments, round-boundary segments and torch's
kernels.  The segments are told apart by their order on the card
(segment ``i % 65`` of a period is a micro-step one unless it is a
multiple of 4), which holds whether a checkout launches one kernel
entry for both kinds or two.  The runs' output goes to standard error;
standard output gets the card's name and power limit, then one JSON
line per run.
"""

import json
import subprocess
import sys

RUN = r"""
import hashlib, json, sys, time
import torch
sys.path.insert(0, ".")
import walnuts_tpu_torch as tw
from walnuts_tpu_torch import _build
from walnuts_tpu_torch.sampler import megakernel as mk
from walnuts_tpu_torch.sampler import round_kernel as rk
from torch.profiler import ProfilerActivity, profile


def split_by_order(prof, periods, unroll, wall):
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    segs = sorted((e for e in cuda if "round_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    per = 16 * unroll + 1
    if len(segs) != periods * per:
        return dict(wall_ms=wall, segment_kernels_seen=len(segs))
    other = [e.time_range.elapsed_us() for e in cuda
             if "round_kernel" not in e.name]
    out = dict(wall_ms=wall)
    for kind in ("micro", "boundary"):
        us = [e.time_range.elapsed_us() for i, e in enumerate(segs)
              if bool((i % per) % unroll) == (kind == "micro")]
        out.update({f"{kind}_n": len(us) // periods,
                    f"{kind}_ms": sum(us) / 1e3 / periods,
                    f"{kind}_us": sum(us) / len(us) if us else 0.0})
    out.update(torch_ms=sum(other) / 1e3 / periods,
               torch_kernels=len(other) / periods)
    busy = out["micro_ms"] + out["boundary_ms"] + out["torch_ms"]
    out["idle"] = max(0.0, 1 - busy / wall)
    return out


dev = torch.device("cuda:0")
torch.cuda.set_device(dev)
_build.load()
release = getattr(rk, "release_graphs", lambda: None)
C, D = 8192, 101
f = tw.targets.funnel(D)
user = tw.Target(f._logp, D, name="funnel_user", logp_grad=f._logp_grad,
                 generated=tw.targets.omega_sumsq)
cfg = tw.WalnutsConfig(m=8)
g = torch.Generator(device=dev).manual_seed(0)
q0 = 0.3 * torch.randn(C, D, generator=g, device=dev)
q0[:, 0] *= 10.0  # omega spread as in the funnel
st0 = mk.init_state(q0, torch.full((C,), 0.0973, device=dev),
                    torch.full((C,), 0.2377, device=dev), target=user,
                    cfg=cfg, warmup=None, num_iter=300, diag_rows=8)
spec = rk.RoundSpec(target=user, cfg=cfg, warmup=None,
                    stop_mode="min_per_chain", num_iter=300, micro_unroll=4,
                    seed=13)
def digest(t):
    b = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(b).hexdigest()[:12]
banks = rk.pack(st0)
out = {}
for i in range(4):
    rk.run_rounds(banks, i * 16, spec)
    torch.cuda.synchronize()
    out[f"sha_period_{i}"] = digest(torch.cat([t.flatten().view(torch.uint8)
                                                for t in banks]))
release()
# the scalar rows and vectors after four periods, to find where two differ
rows = dict(zip(rk.F_FIELDS, banks.sf)) | dict(zip(rk.I_FIELDS, banks.si))
rows |= {f: banks.vx[:, i] for i, f in enumerate(rk.V_FIELDS)}
out["rows"] = {k: digest(v) for k, v in rows.items()}
banks = rk.pack(st0)
rk.run_rounds(banks, 0, spec)
torch.cuda.synchronize()
e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
e0.record()
for i in range(16):
    rk.run_rounds(banks, (i + 1) * 16, spec)
e1.record()
torch.cuda.synchronize()
out["ms_per_period"] = e0.elapsed_time(e1) / 16
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for i in range(8):
        rk.run_rounds(banks, (i + 17) * 16, spec)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 8
release()
out["split"] = split_by_order(prof, 8, 4, wall)
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
