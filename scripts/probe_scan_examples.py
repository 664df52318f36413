#!/usr/bin/env python3
"""Time a short probe of each scan-engine example harness on the card and
project the full run's wall from it.

    python3 scripts/probe_scan_examples.py [--iters 20] [--out FILE]
        [--only funnel_orbit_len funnel multistep gaussian_ess highdim]

(gaussian_transient's d = 2048 row is chip_smoke's phase 12a.)

* ``funnel_orbit_len``: ``--iters`` transitions per H at the harness's
  defaults (128 chains, float32), projected to its 400 per H;
* ``funnel``: ``--iters`` transitions of the WALNUTS arm (all inside
  the 500-transition warmup) and of the NUTS arm at the JAX artifact's
  matched H (0.2118) at 256 chains, projected to 2000 each;
* ``multistep``: 200 iterations of ``ops.masked_multistep`` at the
  transient harness's stamp (funnel(11), 2 chains, float64, from omega
  = -30 at the micro step ``0.3 * 2^-21``), the wall per iteration
  times the gradient evaluations of the native artifacts' chains
  (``examples/out_funnel_transient_native_s{1,2}.json``: the scan
  engine's host loop makes one iteration per gradient evaluation of
  its slowest chain);
* ``gaussian_ess``: ``--iters`` transitions of each arm's first replica
  at every dimension 2^8..2^18, at its ``chains_for`` batch, projected
  to the harness's 1000 per replica;
* ``highdim``: ``--iters`` transitions of each of the four arms at the
  harness's defaults (D = 10^4, 32 chains, float32; the implicit
  midpoint in one chunk), with the fixed-point loop's host syncs,
  projected to its 400 per arm.

Each section prints one JSON line, with the card's name and power
limit; ``--out`` collects them.  Runs on the card unless ``--device
cpu``.  A probe from the funnel harness's start underestimates its run:
its chains have not reached the neck yet (on the H100, 2.15 s per
WALNUTS + NUTS transition pair over 20 transitions, 9.41 s over 150).
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from walnuts_tpu_torch.examples import common  # noqa: E402
from walnuts_tpu_torch.examples import funnel as fx  # noqa: E402
from walnuts_tpu_torch.examples import funnel_orbit_len as fol  # noqa: E402
from walnuts_tpu_torch.utils.device import resolve_device  # noqa: E402

NUTS_H_JAX = 0.21184800565242767   # examples/out_funnel.json
# the native artifacts' gradient evaluations over 1200 iterations (the
# sum of their first 400 rows' counts; the rest add under 0.1%)
NATIVE = ("examples/out_funnel_transient_native_s1.json",
          "examples/out_funnel_transient_native_s2.json")


def probe_orbit_len(dev, iters):
    out = {}
    for h in fol.HS:
        *_, seconds = fol.run(h, fol.start(128), iters, dev)
        out[str(h)] = {"seconds": seconds, "s_per_transition": seconds / iters}
    out["projected_full_seconds"] = sum(
        r["s_per_transition"] for r in out.values()) * 400
    return out


def probe_funnel(dev, iters):
    q0 = fx.start(256, 11)
    *_, s_w = fx.run_walnuts_arm(q0, m=10, warmup=500, iters=iters,
                                 device=dev)
    *_, s_n = fx.run_nuts_arm(q0, NUTS_H_JAX, m=10, iters=iters, device=dev)
    return {"walnuts_warmup_s_per_transition": s_w / iters,
            "nuts_s_per_transition": s_n / iters,
            "projected_full_seconds": (s_w + s_n) / iters * 2000}


def probe_multistep(dev, iters, n=200):
    from walnuts_tpu_torch.ops import PhasePoint, hamiltonian, masked_multistep
    from walnuts_tpu_torch.targets import funnel
    t = funnel(11)
    q = torch.zeros((2, 11), dtype=torch.float64, device=dev)
    q[:, 0] = -30.0
    v = torch.ones_like(q)
    lp, g = t.logp_grad(q)
    h_micro = torch.full((2,), 0.3 * 2.0 ** -21, dtype=torch.float64,
                         device=dev)
    nsteps = torch.full((2,), n, dtype=torch.int64, device=dev)
    s = PhasePoint(q, v, g, lp)
    h0 = hamiltonian(lp, v)
    masked_multistep(t, s, h0, h_micro, torch.full_like(nsteps, 10))
    t0 = common.clock(dev)
    res = masked_multistep(t, s, h0, h_micro, nsteps)
    wall = common.clock(dev) - t0
    assert int(res.n_evals.min()) == n and bool(res.all_finite.all())
    grads = [sum(json.loads((HERE / p).read_text())["grad_evals_per_iter"])
             for p in NATIVE]
    return {"ms_per_iteration": 1e3 * wall / n, "native_grad_evals": grads,
            "projected_seconds": [wall / n * g for g in grads]}


def probe_gaussian_ess(dev, iters):
    from walnuts_tpu_torch.examples import gaussian_ess as ge
    rows, full = [], 0.0
    for log2d in range(8, 19):
        d = 2 ** log2d
        n_rep = -(-64 // ge.chains_for(d, 64))
        for integ, tag in ge.INTEGRATORS:
            r = ge.run_one(log2d, integ, 64, iters, device=dev)
            full += r["s_per_transition"] * n_rep * 1000
            rows.append({"d": d, "arm": tag, "replicas": n_rep, **{
                k: r[k] for k in ("chains", "s_per_transition",
                                  "grad_evals_max_chain_per_transition",
                                  "ess_per_1000_grad_q0")},
                "peak_memory_bytes": r.get("peak_memory_bytes")})
            print(json.dumps(rows[-1]), flush=True)
    return {"rows": rows, "projected_full_seconds": full}


def probe_highdim(dev, iters):
    from walnuts_tpu_torch.examples import highdim_variants as hv
    arms = {}
    for arm in hv.ARMS:
        r = hv.run_arm(arm, iters=iters, chunk=iters, device=dev)
        arms[arm] = {k: r[k] for k in (
            "s_per_transition", "grad_evals_per_s",
            "grad_evals_max_chain_per_transition", "z_mean_q0",
            "z_mean_qlast", "z_radius_sq")}
        arms[arm]["fixed_point_syncs_per_transition"] = r.get(
            "fixed_point_syncs_per_transition")
        print(json.dumps({arm: arms[arm]}), flush=True)
    return {"arms": arms, "projected_full_seconds": sum(
        a["s_per_transition"] for a in arms.values()) * 400}


PROBES = {"funnel_orbit_len": probe_orbit_len, "funnel": probe_funnel,
          "multistep": probe_multistep, "gaussian_ess": probe_gaussian_ess,
          "highdim": probe_highdim}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="+", default=list(PROBES),
                    choices=list(PROBES))
    ap.add_argument("--out", default=None)
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = common.card_name()
    print(card, flush=True)
    lines = []
    for name in args.only:
        t0 = common.clock(dev)
        res = PROBES[name](dev, args.iters)
        lines.append({"probe": name, "card": card,
                      "wall_s": common.clock(dev) - t0, **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        common.atomic_dump(lines, args.out)


if __name__ == "__main__":
    main()
