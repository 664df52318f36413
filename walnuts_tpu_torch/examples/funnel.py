"""Funnel experiments: posterior validity, tail QQ, orbit statistics and
the matched-work NUTS comparison, on the scan engine (the port of
``examples/funnel.py``).

Regenerates the reference's ``funnel/`` experiments:

* the main WALNUTS run with per-chain warmup adaptation and whole-orbit
  statistics (``mainFunnel.py:24-47``: H0 = delta0 = 0.3);
* validation against the exact ``omega ~ N(0, 3^2)`` marginal: moments,
  the tail fraction and a tail-only QQ below ``omega < -3``
  (``plotsFunnel.py:49,103-122``);
* the matched-work multinomial-NUTS baseline at ``H = mean(orbitLen /
  nsteps)`` from the WALNUTS diagnostics, and the relative
  gradient-evaluation cost (``mainFunnelNUTS.py:24-37``,
  ``plotsFunnel.py:146``).

Acceptance, as the JAX harness's (``funnel.py:118-150``), each gate
calibrated to the WALNUTS run's omega ESS: the tail fraction within 5
Monte Carlo standard errors of the exact 0.1587, the tail QQ's RMSE
below 5 standard errors of the tail quantile, omega's sd within 5
standard errors of 3.  The harness exits non-zero when a gate fails,
after writing the JSON.

Seeds and starts are the JAX harness's: ``0.1 * normal(PRNGKey(0))``,
then ``PRNGKey(1)`` for WALNUTS and ``PRNGKey(2)`` for NUTS.  The
artifact adds, per arm, its wall (``seconds``) and
``s_per_transition``, the card's name and power limit (``card``) and,
where ``--iters`` or ``--warmup`` is below its default, the cuts and
the full run's projected wall (``reduced``).  The command line runs
float32, as the JAX harness does; :func:`run` takes a dtype.

Usage, on the card (``--device cpu`` runs it on the CPU; without a card
and without that flag it raises)::

    python -m walnuts_tpu_torch.examples.funnel [--dim 11] [--chains 256]
"""

import argparse
import json

import numpy as np
import torch
from scipy import stats

from ..diagnostics import ess
from ..sampler import WalnutsConfig, WarmupConfig, run_walnuts
from ..targets import funnel
from ..utils import threefry
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .common import add_device_flag, atomic_dump, card_name, clock, cuts

H0 = DELTA0 = 0.3
SEED_WALNUTS, SEED_NUTS = 1, 2


def start(chains, dim, dtype=torch.float32):
    """The JAX harness's start (``funnel.py:49-50``), on the CPU."""
    return 0.1 * threefry.normal(threefry.PRNGKey(0), (chains, dim), dtype)


def run_walnuts_arm(q0, *, m, warmup, iters, device=DEFAULT_DEVICE):
    """The main WALNUTS run (``funnel.py:53-58``): ``(samples, diags,
    state, omin, omax, seconds)``."""
    dev = resolve_device(device)
    t0 = clock(dev)
    out = run_walnuts(
        SEED_WALNUTS, q0, target=funnel(q0.shape[1]),
        cfg=WalnutsConfig(m=m, record_orbit_stats=True),
        warmup=WarmupConfig(warmup_iter=warmup), num_iter=iters, h0=H0,
        delta0=DELTA0, collect_orbit_stats=True, device=dev)
    return out + (clock(dev) - t0,)


def matched_h(diags, warmup):
    """The matched-work NUTS step (``funnel.py:95-96``): the mean over
    post-warmup transitions of orbit time length over gradient
    evaluations, times two (forward and backward count twice), in the
    run's dtype as the JAX harness computes it."""
    dg = diags.cpu().numpy()[warmup:]
    return float((dg[..., 2] / np.maximum(
        dg[..., 6] + dg[..., 7], 1)).mean() * 2.0)


def run_nuts_arm(q0, h, *, m, iters, device=DEFAULT_DEVICE):
    """The matched-work NUTS run (``funnel.py:97-101``): ``(samples,
    diags, seconds)``."""
    dev = resolve_device(device)
    t0 = clock(dev)
    samples, diags, _ = run_walnuts(
        SEED_NUTS, q0, target=funnel(q0.shape[1]),
        cfg=WalnutsConfig(m=m, integrator="fixed_leapfrog"),
        warmup=WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False),
        num_iter=iters, h0=h, delta0=DELTA0, device=dev)
    return samples, diags, clock(dev) - t0


def _omega_ess(w, dev):
    return float(ess(torch.from_numpy(w).to(dev)))


def report(dim, warmup, walnuts, nuts, h_micro, device=DEFAULT_DEVICE):
    """The JAX harness's record (``funnel.py:59-116``) from the two
    runs' outputs: ``walnuts = (samples, diags, state, omin, omax)``,
    ``nuts = (samples, diags)``, both sliced past ``warmup``."""
    dev = resolve_device(device)
    samples, diags, state, omin, omax = walnuts
    w = np.asarray(samples.cpu().numpy(), np.float64)[warmup + 1:, :, 0]
    dg = diags.cpu().numpy()[warmup:]
    nev_w = dg[..., 6].sum() + dg[..., 7].sum()

    flat = w.ravel()
    # tail QQ: empirical quantiles of omega < -3 vs the exact N(0,9) tail
    tail = np.sort(flat[flat < -3.0])
    p_tail = stats.norm.cdf(-3.0, 0, 3.0)
    probs = (np.arange(len(tail)) + 0.5) / len(tail) * p_tail
    theo = stats.norm.ppf(probs, 0, 3.0)
    tail_rmse = float(np.sqrt(np.mean((tail - theo) ** 2))) if len(tail) \
        else float("nan")

    e_w = _omega_ess(w, dev)
    res = {
        "dim": dim,
        "walnuts": {
            "omega_mean": float(flat.mean()),
            "omega_sd": float(flat.std()),
            "omega_sd_exact": 3.0,
            "tail_qq_rmse_below_-3": tail_rmse,
            "tail_fraction": float((flat < -3.0).mean()),
            "tail_fraction_exact": float(p_tail),
            "ess_omega": e_w,
            "grad_evals": float(nev_w),
            "ess_per_1000_grad": 1000.0 * e_w / nev_w,
            "H_final_median": float(np.median(state.h.cpu().numpy())),
            "delta_final_median": float(np.median(state.delta.cpu().numpy())),
            "orbit_omega_min_mean": float(omin.cpu().numpy()[..., 0].mean()),
            "orbit_omega_max_mean": float(omax.cpu().numpy()[..., 0].mean()),
        },
    }

    samples_n, diags_n = nuts
    wn = np.asarray(samples_n.cpu().numpy(), np.float64)[warmup + 1:, :, 0]
    dgn = diags_n.cpu().numpy()[warmup:]
    nev_n = dgn[..., 6].sum() + dgn[..., 7].sum()
    e_n = _omega_ess(wn, dev)
    res["nuts_matched"] = {
        "H": h_micro,
        "omega_mean": float(wn.mean()),
        "omega_sd": float(wn.std()),
        "tail_fraction": float((wn < -3.0).mean()),
        "ess_omega": e_n,
        "grad_evals": float(nev_n),
        "ess_per_1000_grad": 1000.0 * e_n / nev_n,
    }
    res["relative_cost_nuts_over_walnuts"] = float(nev_n / nev_w)
    res["acceptance"] = acceptance(res["walnuts"])
    return res


def acceptance(wres):
    """The JAX harness's gates (``funnel.py:118-143``) over the WALNUTS
    record: the reference's visual QQ gate made numeric and calibrated
    to the Monte Carlo error of omega's ESS."""
    p_tail = wres["tail_fraction_exact"]
    n_eff = max(wres["ess_omega"], 1.0)
    se_tail = np.sqrt(p_tail * (1 - p_tail) / n_eff)
    gates = {
        # WALNUTS resolves the tail mass within 5 MC standard errors
        "tail_fraction_gap": abs(wres["tail_fraction"] - p_tail),
        "tail_fraction_tol": 5 * se_tail,
        # tail QQ: the se of the p_tail-quantile estimate from n_eff
        # effective draws is sqrt(p(1-p)/n_eff)/f(q_p); deeper tail
        # points have smaller density (larger se), so the tol uses
        # f(-3) (the densest tail point) with 5x headroom
        "tail_qq_rmse_tol": 5 * float(np.sqrt(
            p_tail * (1 - p_tail) / n_eff)
            / stats.norm.pdf(-3.0, 0, 3.0)),
        "tail_qq_rmse": wres["tail_qq_rmse_below_-3"],
        # omega sd within 5 MC standard errors of the exact 3.0
        "omega_sd_gap": abs(wres["omega_sd"] - 3.0),
        "omega_sd_tol": 5 * 3 * float(np.sqrt(0.5 / n_eff)),
    }
    gates["pass"] = bool(
        gates["tail_fraction_gap"] < gates["tail_fraction_tol"]
        and gates["tail_qq_rmse"] < gates["tail_qq_rmse_tol"]
        and gates["omega_sd_gap"] < gates["omega_sd_tol"])
    return gates


def run(*, dim, chains, iters, warmup, m, dtype=torch.float32,
        device=DEFAULT_DEVICE):
    """Both runs and the record, each arm with its wall and seconds per
    transition."""
    q0 = start(chains, dim, dtype)
    *walnuts, s_w = run_walnuts_arm(q0, m=m, warmup=warmup, iters=iters,
                                    device=device)
    h_micro = matched_h(walnuts[1], warmup)
    *nuts, s_n = run_nuts_arm(q0, h_micro, m=m, iters=iters, device=device)
    res = report(dim, warmup, walnuts, nuts, h_micro, device)
    res["walnuts"].update(seconds=s_w, s_per_transition=s_w / iters,
                          grad_evals_max_chain_per_transition=_max_chain(
                              walnuts[1]))
    res["nuts_matched"].update(seconds=s_n, s_per_transition=s_n / iters,
                               grad_evals_max_chain_per_transition=_max_chain(
                                   nuts[1]))
    return res


def _max_chain(diags):
    g = diags[..., 6].double() + diags[..., 7].double()
    return float(g.amax(dim=1).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m walnuts_tpu_torch.examples.funnel",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=11)
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--out", default="walnuts_tpu_torch/examples/"
                                     "out_funnel.json")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    card = card_name()
    print(card, flush=True)
    res = run(dim=args.dim, chains=args.chains, iters=args.iters,
              warmup=args.warmup, m=args.m, device=dev)
    res["card"] = card
    reduced = cuts(ap, args, ["iters", "warmup"])
    if reduced:
        iters, warmup = ap.get_default("iters"), ap.get_default("warmup")
        res["reduced"] = dict(reduced, projected_full_seconds=(
            res["walnuts"]["s_per_transition"] * iters
            + res["nuts_matched"]["s_per_transition"] * iters))
    print(json.dumps(res, indent=1, default=float))
    atomic_dump(res, args.out)
    if not res["acceptance"]["pass"]:
        raise SystemExit("FAIL: funnel acceptance gates not met")


if __name__ == "__main__":
    main()
