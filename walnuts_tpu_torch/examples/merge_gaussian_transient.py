"""Merge per-dimension gaussian-transient fragments into
``walnuts_tpu_torch/examples/out_gaussian_transient.json`` (the port of
``examples/merge_gaussian_transient.py``; fragments are lists of rows
written by ``python -m walnuts_tpu_torch.examples.gaussian_transient``).

The summary's keys are the JAX script's: the dims, each arm's first
iteration with >= 95% of chains inside the band, whether every arm made
it within 31 iterations, and NUTS's gradient evaluations over
WALNUTS-D's.  It exits non-zero if an arm missed the band.

Usage: python -m walnuts_tpu_torch.examples.merge_gaussian_transient
       frag1.json ... [--f64-crosscheck frag.json] [--out ...]
"""

import argparse
import json

from .common import atomic_dump

ARM_TAGS = ("walnuts_d", "walnuts_r2p", "nuts")
BUDGET = 31


def summarize(rows):
    """The JAX script's ``summary`` of rows sorted by dimension."""
    return {
        "dims": [r["d"] for r in rows],
        "iters_to_95pct_inside": {
            arm: [r[arm]["iters_to_95pct_inside"] for r in rows]
            for arm in ARM_TAGS},
        "all_within_31": all(
            0 <= r[arm]["iters_to_95pct_inside"] <= BUDGET
            for r in rows for arm in ARM_TAGS),
        # the experiment's cost content: NUTS needs H = d^{-1/2} to
        # survive the transient, WALNUTS auto-refines at H = d^{-1/4}
        "grad_evals_nuts_over_walnuts_d": [
            round(r["nuts"]["cum_grad_evals_mean"][-1]
                  / r["walnuts_d"]["cum_grad_evals_mean"][-1], 2)
            for r in rows],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m walnuts_tpu_torch.examples.merge_gaussian_transient",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("fragments", nargs="+")
    ap.add_argument("--f64-crosscheck", default=None)
    ap.add_argument("--out", default="walnuts_tpu_torch/examples/"
                                     "out_gaussian_transient.json")
    args = ap.parse_args(argv)

    rows = []
    for f in args.fragments:
        with open(f) as fh:
            rows.extend(json.load(fh))
    rows.sort(key=lambda r: r["d"])
    summary = summarize(rows)
    out = {"rows": rows, "summary": summary}
    if args.f64_crosscheck:
        with open(args.f64_crosscheck) as fh:
            out["f64_crosscheck"] = json.load(fh)
    atomic_dump(out, args.out)
    print(json.dumps(summary))
    if not summary["all_within_31"]:
        raise SystemExit("FAIL: an arm missed the 31-iteration band")


if __name__ == "__main__":
    main()
