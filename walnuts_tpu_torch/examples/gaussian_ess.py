"""Stationary-efficiency experiment: ESS per 1000 gradient evaluations
against dimension on the iid standard normal, on the scan engine (the
port of ``examples/gaussian_ess.py``).

Regenerates the reference experiment
``WALNUTSpy_examples/gaussian/mainGaussESS.py:20-89`` /
``plotsGaussESS.py:67-78``: for ``d = 2^dmin .. 2^dmax`` (the reference
goes to 2^18), run WALNUTS (R2P and D) and multinomial NUTS (fixed
leapfrog) at ``H = 1.4 d^{-1/4}`` with M = 10 and no adaptation, and
record ``1000 * ess / grad_evals`` for ``q[0]`` and ``sum(q^2)``,
against the theory guide ``ESS/grad ~ d^{-1/4}``.  The chain batch is
the repetition axis; where it must shrink at large d (``chains_for``),
independent replicas restore ``--target-chains`` chains and their ESS
pools additively.  Samples are stored as the generated quantities
``[q_0, sum(q^2)]``, never the whole ``[iters, C, d]`` history.

Acceptance, as the JAX harness's (``gaussian_ess.py:214-222``): the
OLS slope of ``log(ESS per 1000 grads of q_0)`` against ``log d`` on
the R2P line lies within ``max(0.08, 3 se)`` of the theory's -0.25;
the harness exits non-zero otherwise, after writing the JSON.

Seeds and starts are the JAX harness's: the start of replica ``rep`` at
``d = 2^k`` is ``normal(PRNGKey(1000 rep + k))`` in float32, and the
chunk that starts at transition ``done`` runs under ``fold_in(PRNGKey(100
+ 1000 rep + k), done)``, resuming the last chunk's state.  What
differs from it: every program runs in this process (no subprocess, no
retry, and no fragment of an earlier run is read back), and the ESS is
taken in float64.  The JSON adds the card's name and power limit
(``card``), the sweep's wall (``seconds``, that of a ``--merge-from``
artifact included), each program's wall,
``s_per_transition``, the slowest chain's gradient evaluations per
transition and the card's peak memory (``programs``), and, where
``--iters`` is below its default, the cut and the full run's projected
wall (``reduced``).

Usage, on the card (``--device cpu`` runs it on the CPU; without a card
and without that flag it raises)::

    python -m walnuts_tpu_torch.examples.gaussian_ess [--dmax 18] \\
        [--chains 64] [--iters 1000]
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..diagnostics import ess
from ..sampler import WalnutsConfig, WarmupConfig, run_walnuts
from ..targets import std_gauss
from ..utils import threefry
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .common import add_device_flag, atomic_dump, card_name, clock, cuts

INTEGRATORS = [("adapt_leapfrog_r2p", "walnuts_r2p"),
               ("adapt_leapfrog_d", "walnuts_d"),
               ("fixed_leapfrog", "nuts")]
M = 10
DELTA0 = 0.3
THEORY_SLOPE = -0.25


def chains_for(d, chains):
    """The chain batch at dimension ``d``: the orbit state slab stays
    under ~1 GB at the top dims (``gaussian_ess.py:52-54``)."""
    return max(8, min(chains, (1 << 22) // d))


def default_chunk(d):
    """The JAX harness's chunk of transitions per engine call."""
    return max(25, min(100, (1 << 21) // d))


def _q0_and_sum_sq(q):
    return torch.stack([q[..., 0], torch.sum(q * q, dim=-1)], dim=-1)


def target(d):
    """std_gauss(d) storing ``[q_0, sum(q^2)]`` (``gaussian_ess.py:68-73``)."""
    return std_gauss(d, generated=_q0_and_sum_sq)


def start(log2d, chains, rep=0, dtype=torch.float32):
    """The JAX harness's start: ``normal(PRNGKey(1000 rep + log2d))``,
    ``[chains, 2^log2d]``, on the CPU."""
    return threefry.normal(threefry.PRNGKey(1000 * rep + log2d),
                           (chains, 2 ** log2d), dtype)


def chunk_key(log2d, rep, done):
    """The key of the chunk that starts at transition ``done``."""
    return threefry.fold_in(threefry.PRNGKey(100 + 1000 * rep + log2d), done)


def sample(log2d, integ, q0, iters, rep=0, *, chunk=None,
           device=DEFAULT_DEVICE):
    """The JAX harness's chunked loop (``gaussian_ess.py:87-100``) from
    ``q0``: ``(draws [iters, C, 2] float64, diagnostics [iters, C, 24]
    float64, seconds)`` as numpy arrays."""
    dev = resolve_device(device)
    d = 2 ** log2d
    cfg = WalnutsConfig(m=M, integrator=integ)
    wu = WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    chunk = chunk or default_chunk(d)
    t = target(d)
    state = None
    s_parts, d_parts = [], []
    done = 0
    t0 = clock(dev)
    while done < iters:
        n = min(chunk, iters - done)
        samples, diags, state = run_walnuts(
            chunk_key(log2d, rep, done), q0, target=t, cfg=cfg, warmup=wu,
            num_iter=n, h0=1.4 * d ** -0.25, delta0=DELTA0,
            resume_state=state, device=dev)
        s_parts.append(samples[1:].double().cpu().numpy())
        d_parts.append(diags.double().cpu().numpy())
        done += n
    seconds = clock(dev) - t0
    return np.concatenate(s_parts), np.concatenate(d_parts), seconds


def record(s, dg):
    """The JAX harness's record of one program (``gaussian_ess.py:101-
    111``) from its draws and diagnostics, plus the mean over
    transitions of the largest gradient count of any chain (the scan
    engine's host loop runs that many micro steps per transition)."""
    grads = dg[..., 6] + dg[..., 7]
    nev = dg[..., 6].sum() + dg[..., 7].sum()
    e_q0 = float(ess(torch.from_numpy(np.ascontiguousarray(s[..., 0]))))
    e_sq = float(ess(torch.from_numpy(np.ascontiguousarray(s[..., 1]))))
    return {
        "chains": s.shape[1],
        "ess_per_1000_grad_q0": 1000.0 * e_q0 / nev,
        "ess_per_1000_grad_sumsq": 1000.0 * e_sq / nev,
        "grad_evals": float(nev),
        "grad_evals_max_chain_per_transition": float(grads.max(axis=1).mean()),
    }


def run_one(log2d, integ, chains, iters, rep=0, *, dtype=torch.float32,
            device=DEFAULT_DEVICE, chunk=None):
    """One (dimension, integrator, replica) program: its record, with
    its wall, seconds per transition and the card's peak memory."""
    dev = resolve_device(device)
    q0 = start(log2d, chains_for(2 ** log2d, chains), rep, dtype)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    s, dg, seconds = sample(log2d, integ, q0, iters, rep, chunk=chunk,
                            device=dev)
    res = record(s, dg)
    res.update(rep=rep, seconds=seconds, s_per_transition=seconds / iters)
    if dev.type == "cuda":
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res


def pool(frags, chains):
    """Replicas pooled additively (``gaussian_ess.py:176-186``): the
    arm's entry of a row from its replicas' records."""
    tot_q0 = sum(f["ess_per_1000_grad_q0"] * f["grad_evals"] / 1000.0
                 for f in frags)
    tot_sq = sum(f["ess_per_1000_grad_sumsq"] * f["grad_evals"] / 1000.0
                 for f in frags)
    tot_grad = sum(f["grad_evals"] for f in frags)
    return {"chains": len(frags) * chains,
            "ess_per_1000_grad_q0": 1000.0 * tot_q0 / tot_grad,
            "ess_per_1000_grad_sumsq": 1000.0 * tot_sq / tot_grad,
            "grad_evals": tot_grad}


def fit(rows):
    """The OLS slope of ``log(ESS per 1000 grads of q_0)`` against ``log
    d`` on the R2P line and its standard error (``gaussian_ess.py:189-
    212``)."""
    ds = np.array([r["d"] for r in rows], float)
    effs = np.array([r["walnuts_r2p"]["ess_per_1000_grad_q0"] for r in rows])
    if len(rows) > 2:
        x = np.log(ds)
        y = np.log(np.maximum(effs, 1e-12))
        A = np.vstack([x, np.ones_like(x)]).T
        coef, res_, *_ = np.linalg.lstsq(A, y, rcond=None)
        slope = float(coef[0])
        dof = len(x) - 2
        s2 = float(res_[0]) / dof if res_.size and dof > 0 else 0.0
        se = float(np.sqrt(s2 / np.sum((x - x.mean()) ** 2)))
    elif len(rows) > 1:
        slope = float(np.polyfit(np.log(ds),
                                 np.log(np.maximum(effs, 1e-12)), 1)[0])
        se = float("nan")
    else:
        slope, se = float("nan"), float("nan")
    return {"fit_slope_log_ess_vs_log_d": slope, "fit_slope_stderr": se,
            "theory_slope": THEORY_SLOPE}


def gate(summary):
    """``None`` if the fitted exponent lies within 3 standard errors or
    0.08 of the theory's, whichever is looser (or cannot be fitted);
    else the failure message."""
    slope, se = (summary["fit_slope_log_ess_vs_log_d"],
                 summary["fit_slope_stderr"])
    if not np.isfinite(slope):
        return None
    gap = abs(slope - THEORY_SLOPE)
    tol = max(0.08, 3.0 * (se if np.isfinite(se) else 0.0))
    if gap > tol:
        return (f"FAIL: ESS-scaling slope off theory by {gap:.3f} "
                f"(tol {tol:.3f})")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m walnuts_tpu_torch.examples.gaussian_ess",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--dmax", type=int, default=18)
    ap.add_argument("--dmin", type=int, default=8)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--target-chains", type=int, default=64,
                    help="min total chains per (d, integrator), reached "
                         "via pooled replicas at large d")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--out", default="walnuts_tpu_torch/examples/"
                                     "out_gaussian_ess.json")
    ap.add_argument("--merge-from", default=None,
                    help="existing output whose rows below 2^dmin are kept "
                         "(extend a committed partial sweep to the top "
                         "dims without re-running the bottom); its "
                         "'seconds' count in the output's")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    card = card_name()
    print(card, flush=True)
    results, merged_seconds = [], 0.0
    if args.merge_from:
        merged = json.loads(Path(args.merge_from).read_text())
        results = [r for r in merged["rows"] if r["d"] < 2 ** args.dmin]
        merged_seconds = merged.get("seconds", 0.0)
        print(f"merged {len(results)} rows < 2^{args.dmin} "
              f"from {args.merge_from}")
    reduced = cuts(ap, args, ["iters"])
    summary = fit(results)
    t0 = clock(dev)
    for log2d in range(args.dmin, args.dmax + 1):
        d = 2 ** log2d
        per_rep = chains_for(d, args.chains)
        n_rep = max(1, -(-args.target_chains // per_rep))
        row = {"d": d, "H": 1.4 * d ** -0.25, "replicas": n_rep,
               "chains_per_replica": per_rep, "card": card}
        for integ, tag in INTEGRATORS:
            frags = [run_one(log2d, integ, args.chains, args.iters, rep,
                             device=dev) for rep in range(n_rep)]
            row[tag] = pool(frags, per_rep)
            seconds = sum(f["seconds"] for f in frags)
            row[tag].update(
                seconds=seconds,
                s_per_transition=seconds / (n_rep * args.iters),
                grad_evals_max_chain_per_transition=max(
                    f["grad_evals_max_chain_per_transition"] for f in frags),
                programs=frags)
        results.append(row)
        print(json.dumps(row, default=float), flush=True)
        summary = fit(results)
        seconds = merged_seconds + clock(dev) - t0
        out = {"rows": results, "summary": summary, "card": card,
               "seconds": seconds}
        if reduced:
            out["reduced"] = dict(reduced, projected_full_seconds=(
                seconds * ap.get_default("iters") / args.iters))
        atomic_dump(out, args.out)
    print(json.dumps(summary, default=float))
    msg = gate(summary)
    if msg:
        raise SystemExit(msg)


if __name__ == "__main__":
    main()
