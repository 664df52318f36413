#!/usr/bin/env python3
"""Print the port's scan-engine example artifacts beside the JAX
harnesses' committed ones.

    python3 scripts/compare_scan_examples.py [PORT_DIR [JAX_DIR]]

PORT_DIR defaults to ``walnuts_tpu_torch/examples``, JAX_DIR to
``examples``.  One JSON line per artifact that both directories hold:

* ``out_gaussian_transient.json``: each arm's iterations to 95% inside
  per dimension, both sides, and the port's s per transition;
* ``out_funnel_orbit_len.json``: omega sd, mean gradient evaluations per
  iteration and refinement depth per H;
* ``out_funnel.json``: omega sd, tail fraction, omega ESS, the
  NUTS/WALNUTS cost ratio and the gates;
* ``out_funnel_transient_native_s{1,2}.json``: whether every trace
  equals the JAX one, the first iteration where one differs, and the
  recovery statistics;
* ``out_gaussian_ess.json``: the fitted slope and its standard error,
  both sides, and per dimension each arm's ESS per 1000 gradient
  evaluations of q_0 and sum q^2 and the port's s per transition;
* ``out_highdim_variants.json``: per arm the z-scores, ESS and grad
  evaluations per transition per chain, both sides, and the port's s
  per transition and fixed-point host syncs per transition.

Runs on the CPU; reads the files only.
"""

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def _load(d, name):
    p = Path(d) / name
    return json.loads(p.read_text()) if p.exists() else None


def gaussian_transient(port, jax):
    pr = {r["d"]: r for r in port["rows"]}
    jr = {r["d"]: r for r in jax["rows"]}
    out = {"all_within_31": [port["summary"]["all_within_31"],
                             jax["summary"]["all_within_31"]]}
    for d in sorted(set(pr) & set(jr)):
        out[d] = {arm: {"port": pr[d][arm]["iters_to_95pct_inside"],
                        "jax": jr[d][arm]["iters_to_95pct_inside"],
                        "port_s_per_transition":
                            pr[d][arm].get("s_per_transition")}
                  for arm in ("walnuts_d", "walnuts_r2p", "nuts")}
    return out


def funnel_orbit_len(port, jax):
    jr = {r["H"]: r for r in jax["rows"]}
    return {"reduced": port.get("reduced"), **{
        r["H"]: {k: [r[k] if not isinstance(r[k], dict) else r[k]["mean"],
                     jr[r["H"]][k] if not isinstance(jr[r["H"]][k], dict)
                     else jr[r["H"]][k]["mean"]]
                 for k in ("omega_sd", "grad_evals_per_iter", "refine_max",
                           "orbit_len")}
        for r in port["rows"] if r["H"] in jr}}


def funnel(port, jax):
    keys = ("omega_mean", "omega_sd", "tail_fraction", "ess_omega",
            "ess_per_1000_grad", "H_final_median")
    return {"walnuts": {k: [port["walnuts"][k], jax["walnuts"][k]]
                        for k in keys},
            "nuts_matched": {k: [port["nuts_matched"][k],
                                 jax["nuts_matched"][k]]
                             for k in ("H", "omega_sd", "tail_fraction",
                                       "ess_omega")},
            "relative_cost_nuts_over_walnuts": [
                port["relative_cost_nuts_over_walnuts"],
                jax["relative_cost_nuts_over_walnuts"]],
            "gates_pass": port["acceptance"]["pass"],
            "reduced": port.get("reduced")}


def native(port, jax):
    first = {}
    for k, v in jax.items():
        if isinstance(v, list):
            ne = np.nonzero(np.asarray(v) != np.asarray(port[k]))[0]
            first[k] = int(ne[0]) if len(ne) else None
    return {"traces_equal": all(v is None for v in first.values()),
            "first_difference": {k: v for k, v in first.items()
                                 if v is not None},
            **{k: [port.get(k), jax.get(k)] for k in (
                "iters_to_recovery", "max_if_reached",
                "omega_sd_post_recovery", "omega_mean_post_recovery")},
            "port_seconds": port.get("seconds")}


def gaussian_ess(port, jax):
    jr = {r["d"]: r for r in jax["rows"]}
    keys = ("fit_slope_log_ess_vs_log_d", "fit_slope_stderr")
    return {"summary": {k: [port["summary"][k], jax["summary"][k]]
                        for k in keys},
            "reduced": port.get("reduced"), **{
        r["d"]: {tag: {"q0": [r[tag]["ess_per_1000_grad_q0"],
                              jr[r["d"]][tag]["ess_per_1000_grad_q0"]],
                       "sumsq": [r[tag]["ess_per_1000_grad_sumsq"],
                                 jr[r["d"]][tag]["ess_per_1000_grad_sumsq"]],
                       "port_s_per_transition": r[tag]["s_per_transition"]}
                 for tag in ("walnuts_r2p", "walnuts_d", "nuts")}
        for r in port["rows"] if r["d"] in jr}}


def highdim_variants(port, jax):
    keys = ("z_mean_q0", "z_mean_qlast", "z_radius_sq", "ess_q0",
            "ess_radius_sq", "sd_q0")

    def per_chain(r):
        return r["grad_evals"] / r["chains"] / r["iters"]

    return {"max_abs_z_all": [port["max_abs_z_all"], jax["max_abs_z_all"]],
            "reduced": port.get("reduced"), **{
        arm: {**{k: [r[k], jax["runs"][arm][k]] for k in keys},
              "grads_per_chain_per_transition": [
                  per_chain(r), per_chain(jax["runs"][arm])],
              "iters": [r["iters"], jax["runs"][arm]["iters"]],
              "port_s_per_transition": r["s_per_transition"],
              "port_fixed_point_syncs_per_transition":
                  r.get("fixed_point_syncs_per_transition")}
        for arm, r in port["runs"].items() if arm in jax["runs"]}}


ARTIFACTS = {"out_gaussian_transient.json": gaussian_transient,
             "out_funnel_orbit_len.json": funnel_orbit_len,
             "out_funnel.json": funnel,
             "out_funnel_transient_native_s1.json": native,
             "out_funnel_transient_native_s2.json": native,
             "out_gaussian_ess.json": gaussian_ess,
             "out_highdim_variants.json": highdim_variants}


def main(argv):
    port_dir = argv[0] if argv else HERE / "walnuts_tpu_torch" / "examples"
    jax_dir = argv[1] if len(argv) > 1 else HERE / "examples"
    for name, fn in ARTIFACTS.items():
        port, jax = _load(port_dir, name), _load(jax_dir, name)
        if port is None or jax is None:
            continue
        print(json.dumps({"artifact": name, "card": port.get("card") or (
            port["rows"][0].get("card") if "rows" in port else None),
            **fn(port, jax)}, default=float))


if __name__ == "__main__":
    main(sys.argv[1:])
