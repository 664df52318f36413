#!/usr/bin/env python3
"""Compare two Stock-Watson artifacts arm by arm: the port's harness's
(``walnuts_tpu_torch/examples/out_stock_watson.json``) against the JAX
harness's (``examples/out_stock_watson.json``) by default.

    python3 scripts/sw_band_gaps.py [PORT_JSON [JAX_JSON]]

For each arm both artifacts hold, one JSON line: each artifact's
all-coordinate split-Rhat (the subsampled one where an older JAX
artifact has no other), whether the stamps agree, the band gap (the
largest difference of the 12 band statistics: sigma, z, x, tau at q10,
q50, q90) and the statistic it falls on.  Runs on the CPU; reads the
two files only.
"""

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from walnuts_tpu_torch.examples.stock_watson import band_gap  # noqa: E402


def _rhat(run):
    """The arm's all-coordinate split-Rhat, or (an artifact of the JAX
    harness before its version 6, which has none) the subsampled one."""
    return run.get("max_split_rhat_all_coords",
                   run.get("max_split_rhat_subsampled"))


def main(argv):
    port = Path(argv[0]) if argv else (
        HERE / "walnuts_tpu_torch" / "examples" / "out_stock_watson.json")
    ref = Path(argv[1]) if len(argv) > 1 else (
        HERE / "examples" / "out_stock_watson.json")
    a = json.loads(port.read_text())
    b = json.loads(ref.read_text())
    print(f"{port} ({a.get('card', 'card not recorded')}) against {ref}")
    for tag in a["runs"]:
        if tag not in b["runs"]:
            continue
        ra, rb = a["runs"][tag], b["runs"][tag]
        gap = band_gap(ra, rb)
        where = max(((k, q) for k in ("sigma", "z", "x", "tau")
                     for q in ("q10", "q50", "q90")),
                    key=lambda kq: abs(ra["bands"][kq[0]][kq[1]]
                                       - rb["bands"][kq[0]][kq[1]]))
        print(json.dumps({
            "arm": tag, "band_gap": gap, "at": ".".join(where),
            "split_rhat": _rhat(ra), "split_rhat_ref": _rhat(rb),
            "stamp_equal": ra.get("stamp") == rb.get("stamp")}))


if __name__ == "__main__":
    main(sys.argv[1:])
