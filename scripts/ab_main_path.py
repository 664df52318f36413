#!/usr/bin/env python3
"""Run the port's main path (``chip_smoke.py``'s phase 4) from several
checkouts in turn on one card, to compare them within one call.

    python3 scripts/ab_main_path.py DIR[:ranks] [DIR[:ranks] ...]

Each DIR is a checkout of the repo, such as the parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists.  List
each checkout more than once, alternating, e.g. parent, change, change,
parent.  Each run is a fresh process in DIR: it builds the kernel
(phase 1) and drives phase 4; ``:ranks`` also drives phase 10b (the
main path over two ranks on the card) where the checkout has it.  The
runs' own lines go to standard error; standard output gets the card's
name and power limit, then one JSON line per run with the warmup and
timed walls, grad-evals/s and min-ESS/s read from the phase lines.
"""

import json
import re
import subprocess
import sys

RUN = r"""
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import walnuts_tpu_torch as tw
from walnuts_tpu_torch import _build
from walnuts_tpu_torch.sampler import megakernel as mk
from walnuts_tpu_torch.sampler import round_kernel as rk
dev = torch.device("cuda:0")
torch.cuda.set_device(dev)
cs.phase_build(_build, rk)
out = cs.phase_main(tw, mk, rk, dev)
if sys.argv[1] == "ranks" and hasattr(cs, "phase_ranks_main"):
    cs.phase_ranks_main(tw, mk, rk, dev, out[2])
"""

NUM = r"([\d.]+)"
FIELDS = {
    "phase 4": {"warmup_s": rf"warmup 700 pooled in {NUM} s",
                "timed_s": rf"timed 300 draws in {NUM} s",
                "grad_evals_per_s": rf"= {NUM} grad-evals/s",
                "min_ess_per_s": rf"min-ESS/s {NUM}"},
    "phase 10b main path": {"warmup_s": rf"warmup {NUM} s",
                            "timed_s": rf"timed {NUM} s",
                            "grad_evals_per_s": rf"= {NUM} grad-evals/s",
                            "min_ess_per_s": rf"min-ESS/s {NUM}"},
}


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for i, arg in enumerate(sys.argv[1:]):
        where, _, mode = arg.partition(":")
        proc = subprocess.run([sys.executable, "-c", RUN, mode], cwd=where,
                              capture_output=True, text=True, timeout=1200)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode:
            raise SystemExit(f"run {i} in {where} exited {proc.returncode}")
        for line in proc.stdout.splitlines():
            for phase, fields in FIELDS.items():
                if line.startswith(phase):
                    rec = {k: float(re.search(p, line).group(1))
                           for k, p in fields.items()}
                    print(json.dumps(dict(run=i, dir=where, phase=phase,
                                          **rec)), flush=True)


if __name__ == "__main__":
    main()
