"""BASELINE config 5: the implicit-midpoint and isokinetic WALNUTS
variants at D = 10^4 (the port of ``examples/highdim_variants.py``).

The reference only runs these variants at toy dimension on one CPU core
(implicit midpoint: ``WALNUTSpy/adaptiveIntegrators.py:478-641``;
isokinetic/microcanonical: ``isokinetic/microCanonical.py:266-316``).
This experiment takes the same samplers to D = 10,000 on standard and
ill-conditioned (diagonal variances log-spaced over [1, 1e4])
Gaussians and gates on posterior moments within Monte Carlo error:

* per-coordinate z-scores of the mean of ``q_0`` and ``q_{D-1}``
  (normalised by the target sd) against ESS-based standard errors;
* the normalised squared radius ``sum(q^2 / var)`` against its exact
  chi^2_D law (mean D, sd sqrt(2D)), again with an ESS-based se.

Arms:

* ``im_std`` / ``im_illcond``: WALNUTS with the adaptive implicit
  midpoint integrator (``adapt_implicit_midpoint_d``, a fixed-point
  solve per micro step) on the scan engine, in chunks of ``--chunk``
  transitions, each resuming the last one's state;
* ``iso_std`` / ``iso_illcond``: the isokinetic kernel under the
  generic NUTS orbit driver (``run_generic_nuts``).

Acceptance, as the JAX harness's (``highdim_variants.py:224-231``):
every arm's largest |z| is below 4; the harness exits non-zero
otherwise, after writing the JSON.

Seeds and starts are the JAX harness's: the arm's key is
``PRNGKey(sum(map(ord, arm)))``, the start an exact stationary draw
``sd * normal(key)`` in float32; the implicit-midpoint chunk that starts
at transition ``done`` runs under ``fold_in(key, 7000 + done)``, the
isokinetic run under ``fold_in(key, 1)``.  The ill-conditioned
variances are ``jnp.logspace(0, 4, D)`` as XLA computes it on the CPU
(:func:`logspace`), bit for bit.  What differs from it: the arms run in
this process (no subprocess, no retry, and no fragment of an earlier
run is read back); ``--devices n`` (default 1) splits the chains over n
ranks of one process group on this host (``parallel.run_ranks``) where
the JAX harness shards them over a device mesh.  The draws are one
process's either way.  The JSON adds per arm the card's name and power
limit (``card``), ``s_per_transition``, the slowest chain's gradient
evaluations per transition and, for the implicit midpoint, the host
syncs its fixed-point loop makes per transition; the wall is kept
unrounded; where ``--iters`` is below its default, the cut and the
full run's projected wall (``reduced``).

Usage, on the card (``--device cpu`` runs it on the CPU; without a card
and without that flag it raises)::

    python -m walnuts_tpu_torch.examples.highdim_variants [--dim 10000] \\
        [--chains 32] [--iters 400] [--arms im_std,iso_std]
"""

import argparse
import ctypes
import ctypes.util
import json
import math

import numpy as np
import torch

from .. import parallel
from ..diagnostics import ess, gather_chains
from ..ops import leapfrog
from ..sampler import (IsokineticKernel, WalnutsConfig, WarmupConfig,
                       run_generic_nuts, run_walnuts)
from ..targets import Target
from ..utils import threefry
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .common import add_device_flag, atomic_dump, card_name, clock, cuts

ARMS = ["im_std", "im_illcond", "iso_std", "iso_illcond"]
LOG10_KAPPA = 4.0
DELTA_IM, DELTA_ISO = 0.3, 0.2
IM_KEY_OFFSET = 7000
ESS_FLOOR = 4.0
Z_GATE = 4.0
RANKS_TIMEOUT = 24 * 3600.0


def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


def logspace(start, stop, num, dtype=torch.float32):
    """``jnp.logspace(start, stop, num)`` in ``dtype`` as XLA's CPU backend
    computes it, on the CPU: the linspace ``start (1 - s) + stop s`` with
    ``s = iota * (1 / (num - 1))`` (XLA turns the division by a constant
    into a multiply by its reciprocal), then libm's ``pow`` per entry
    (``powf`` in float32), which is what XLA calls.  torch's own pow
    differs from it in the last bit on ~2% of entries at num = 10^4."""
    div = num - 1
    s = torch.arange(div, dtype=dtype) * (
        torch.tensor(1.0, dtype=dtype) / torch.tensor(float(div), dtype=dtype))
    lin = torch.cat([start * (1 - s) + stop * s,
                     torch.tensor([stop], dtype=dtype)])
    pw = _powf() if dtype == torch.float32 else math.pow
    return torch.tensor([pw(10.0, x) for x in lin.tolist()], dtype=dtype)


def variances(arm, dim, dtype=torch.float32):
    """The arm's diagonal variances (``None`` for the standard normal)."""
    return None if arm.endswith("_std") else logspace(0.0, LOG10_KAPPA, dim,
                                                      dtype)


def make_target(arm, dim, dtype=torch.float32):
    """The arm's target in ``dtype``, with the generated quantities
    ``[q_0 / sd_0, q_last / sd_last, sum(q^2 / var)]`` (``highdim_
    variants.py:54-86``): everything the moment gates need, at storage
    cost 3 instead of D.  The variances are moved to a position's
    device once per device."""
    var_cpu = variances(arm, dim, dtype)
    consts = {}

    def const(q):
        if q.device not in consts:
            var = (torch.ones(dim, dtype=dtype) if var_cpu is None
                   else var_cpu).to(q.device)
            consts[q.device] = (var, torch.sqrt(var))
        return consts[q.device]

    if var_cpu is None:
        def logp_grad(q):
            return -0.5 * torch.sum(q * q, dim=-1), -q

        name = f"std_gauss_{dim}"
    else:
        def logp_grad(q):
            var = const(q)[0]
            return -0.5 * torch.sum(q * q / var, dim=-1), -q / var

        name = f"ill_gauss_{dim}"

    def generated(q):
        qn = q / const(q)[1]
        return torch.stack([qn[..., 0], qn[..., -1],
                            torch.sum(qn * qn, dim=-1)], dim=-1)

    return Target(lambda q: logp_grad(q)[0], dim, name=name,
                  generated=generated, logp_grad=logp_grad)


def arm_key(arm):
    return threefry.PRNGKey(sum(map(ord, arm)))


def start(arm, chains, dim, dtype=torch.float32):
    """The JAX harness's exact stationary start (``:104-109``), on the
    CPU."""
    q0 = threefry.normal(arm_key(arm), (chains, dim), dtype)
    var = variances(arm, dim, dtype)
    return q0 if var is None else torch.sqrt(var) * q0


def h_macro(dim):
    return 1.4 * dim ** -0.25


def sample(arm, q0, *, iters, chunk=50, m=9, device=DEFAULT_DEVICE,
           mesh=None):
    """The JAX harness's engine calls (``:114-143``) from ``q0`` (this
    rank's block of chains under ``mesh``): ``(draws [iters, C, 3],
    diagnostics, gradient evaluations [iters, C], seconds, fixed-point
    host syncs)``, the tensors on the CPU and joined over the mesh's
    ranks."""
    dev = resolve_device(device)
    dim = q0.shape[-1]
    t = make_target(arm, dim, q0.dtype)
    key = arm_key(arm)
    leapfrog.fixed_point_syncs = 0
    t0 = clock(dev)
    if arm.startswith("im_"):
        cfg = WalnutsConfig(m=m, integrator="adapt_implicit_midpoint_d")
        wu = WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
        state = None
        s_parts, d_parts = [], []
        done = 0
        while done < iters:
            n = min(chunk, iters - done)
            s, dg, state = run_walnuts(
                threefry.fold_in(key, IM_KEY_OFFSET + done), q0, target=t,
                cfg=cfg, warmup=wu, num_iter=n, h0=h_macro(dim),
                delta0=DELTA_IM, resume_state=state, device=dev, mesh=mesh)
            s_parts.append(s[1:])
            d_parts.append(dg)
            done += n
        s, dg = torch.cat(s_parts), torch.cat(d_parts)
        grads = dg[..., 6].double() + dg[..., 7].double()
    else:
        s, dg = run_generic_nuts(
            threefry.fold_in(key, 1), q0, target=t,
            kernel=IsokineticKernel(), h_macro=h_macro(dim), delta=DELTA_ISO,
            num_iter=iters, m=m, device=dev, mesh=mesh)
        s = s[1:]
        grads = dg[..., 7].double()
    seconds = clock(dev) - t0
    s, dg, grads = (gather_chains(x, mesh).cpu() for x in (s, dg, grads))
    return s, dg, grads, seconds, leapfrog.fixed_point_syncs


def zscore(x, true_mean, true_sd):
    """The z-score of ``x``'s mean against an ESS-based standard error,
    with the ESS floored at 4, and that ESS (``:203-206``)."""
    e = max(float(ess(torch.from_numpy(np.ascontiguousarray(x)))), ESS_FLOOR)
    se = true_sd / np.sqrt(e)
    return float((x.mean() - true_mean) / se), e


def record(arm, s, grads, seconds, *, dim, iters, devices=1, syncs=None):
    """The JAX harness's record of an arm (``:208-231``) from its draws
    ``[iters, C, 3]`` and gradient counts ``[iters, C]``, plus the
    seconds per transition, the slowest chain's gradient evaluations per
    transition and, for the implicit midpoint, the fixed-point loop's
    host syncs per transition."""
    s = np.asarray(s, np.float64)
    grads = np.asarray(grads, np.float64)
    n_grad = float(grads.sum())
    z0, e0 = zscore(s[..., 0], 0.0, 1.0)
    zl, el = zscore(s[..., 1], 0.0, 1.0)
    zr, er = zscore(s[..., 2], float(dim), float(np.sqrt(2 * dim)))
    res = {
        "arm": arm, "dim": dim, "chains": s.shape[1], "devices": devices,
        "iters": iters, "H": h_macro(dim),
        "seconds": seconds,
        "grad_evals": n_grad,
        "grad_evals_per_s": n_grad / seconds,
        "z_mean_q0": z0, "ess_q0": e0,
        "z_mean_qlast": zl, "ess_qlast": el,
        "z_radius_sq": zr, "ess_radius_sq": er,
        "sd_q0": float(s[..., 0].std()),
        "radius_sq_mean": float(s[..., 2].mean()),
        "radius_sq_expected": float(dim),
        "s_per_transition": seconds / iters,
        "grad_evals_max_chain_per_transition": float(
            grads.max(axis=1).mean()),
    }
    if arm.startswith("im_"):
        res["fixed_point_syncs_per_transition"] = syncs / iters
    return res


def max_abs_z(res):
    return max(abs(res[k]) for k in ("z_mean_q0", "z_mean_qlast",
                                     "z_radius_sq"))


def _rank_arm(arm, kw):
    """One rank of :func:`run_arm` over ``devices`` ranks: its block of
    the chains, the joined draws and its wall and syncs."""
    mesh = parallel.make_mesh()
    q0 = parallel.shard_chains(start(arm, kw["chains"], kw["dim"],
                                     kw["dtype"]), mesh)
    s, _, grads, seconds, syncs = sample(
        arm, q0, iters=kw["iters"], chunk=kw["chunk"], m=kw["m"],
        device=kw["device"], mesh=mesh)
    return s, grads, seconds, syncs


def draws(arm, *, dim=10000, chains=32, iters=400, chunk=50, m=9,
          dtype=torch.float32, device=DEFAULT_DEVICE, devices=1):
    """One arm from the harness's start, in this process or (``devices >
    1``) with its chains split over that many ranks on this host:
    ``(draws [iters, C, 3], gradient evaluations [iters, C], seconds,
    fixed-point host syncs)`` (the slowest rank's wall, the most syncs
    of any rank)."""
    dev = resolve_device(device)
    if devices == 1:
        s, _, grads, seconds, syncs = sample(
            arm, start(arm, chains, dim, dtype), iters=iters, chunk=chunk,
            m=m, device=dev)
        return s, grads, seconds, syncs
    kw = dict(chains=chains, dim=dim, iters=iters, chunk=chunk, m=m,
              dtype=dtype, device=dev.type)
    outs = parallel.run_ranks(_rank_arm, devices, (arm, kw),
                              device=dev.type, timeout=RANKS_TIMEOUT)
    s, grads = outs[0][:2]
    return (s, grads, max(o[2] for o in outs), max(o[3] for o in outs))


def run_arm(arm, *, dim=10000, chains=32, iters=400, chunk=50, m=9,
            dtype=torch.float32, device=DEFAULT_DEVICE, devices=1):
    """One arm's record (:func:`draws`, then :func:`record`)."""
    s, grads, seconds, syncs = draws(
        arm, dim=dim, chains=chains, iters=iters, chunk=chunk, m=m,
        dtype=dtype, device=device, devices=devices)
    return record(arm, s, grads, seconds, dim=dim, iters=iters,
                  devices=devices, syncs=syncs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m walnuts_tpu_torch.examples.highdim_variants",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=10000)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks on this host to split the chains over")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--m", type=int, default=9)
    ap.add_argument("--out", default="walnuts_tpu_torch/examples/"
                                     "out_highdim_variants.json")
    ap.add_argument("--arms", default=",".join(ARMS))
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    card = card_name()
    print(card, flush=True)
    reduced = cuts(ap, args, ["iters"])
    runs = {}
    for arm in args.arms.split(","):
        res = run_arm(arm, dim=args.dim, chains=args.chains,
                      iters=args.iters, chunk=args.chunk, m=args.m,
                      device=dev, devices=args.devices)
        res["card"] = card
        res["max_abs_z"] = max_abs_z(res)
        runs[arm] = res
        print(json.dumps(res, default=float), flush=True)
        atomic_dump({"runs": runs}, args.out)

    worst = max(r["max_abs_z"] for r in runs.values())
    res = {"runs": runs, "max_abs_z_all": worst, "gate_z": Z_GATE,
           "card": card, "seconds": sum(r["seconds"] for r in runs.values())}
    if reduced:
        res["reduced"] = dict(reduced, projected_full_seconds=sum(
            r["s_per_transition"] for r in runs.values())
            * ap.get_default("iters"))
    atomic_dump(res, args.out)
    print(json.dumps({k: round(r["max_abs_z"], 2) for k, r in runs.items()}
                     | {"max_abs_z_all": round(worst, 2)}), flush=True)
    if worst >= Z_GATE:
        raise SystemExit("FAIL: a moment z-score exceeds 4")


if __name__ == "__main__":
    main()
