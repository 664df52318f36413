"""The control of a cell's check: the plain reference put in the
program's place and computed in the precision below the configuration's
(``precision.control``: bfloat16 for float32), judged by the same
comparison as a run.  A sound limit passes every sound run and fails the
control.

    python3 portbench/control.py --workload NAME --seeds S [S ...]
        [--device cuda]

For each seed it prints one JSON line with the control's numbers, as
the cell's entry (``entries/<entry>.py``, its ``control``) reads them:
for the fused engine ``mismatch_share`` (the lower-precision
reference's chains against the reference at the configuration's
precision, over the check's sampled chains and rounds at the cell's
batch) and, for a cell with a ``consensus`` check, ``consensus_gap``
(the consensus worked out in the lower precision from the program's
estimators after each of the check's periods, against the program's).
The benchmark's runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    import inputs
    from cell import Cell

    cell = Cell(args.workload, root=ROOT)
    dev = torch.device("cuda:0" if args.device == "cuda" else args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    prec = cell.config["precision"]
    low = inputs.DTYPES[prec["control"]]
    entry = inputs.load_module(HERE / "entries" / f"{cell.run['entry']}.py",
                               "portbench_entry_" + cell.run["entry"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = {"workload": cell.name, "seed": seed,
               "control": prec["control"]}
        out.update(entry.control(cell, seed, dev, low))
        out["control_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
