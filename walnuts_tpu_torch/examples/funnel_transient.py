"""Funnel transient from deep in the neck: start at omega = -30 with
refinement depth allowed up to maxC = 30 and show recovery (the port of
``examples/funnel_transient.py``).

Regenerates ``mainFunnelTransient.py:14-40``: WALNUTS-R2P, D = 11,
``M = 12, H0 = 0.3, delta0 = 0.3, minC = 0, maxC = 30``, no warmup,
whole-orbit statistics.  At omega = -30 the conditional curvature is
``e^{30} ~ 1e13``, so the step-halving search must reach micro steps
of ``~0.3 * 2^{-21}``.  Recorded, as the JAX harness records them: the
omega draws, whole-orbit omega min/max, the micro-step range ``0.3 *
2^{-If}`` and the orbit's energy error; plus the iterations to
recovery (the first draw with omega > -5).

Two engines, selected by ``--engine``:

* ``native``: one float64 chain on the native C++ engine
  (:mod:`walnuts_tpu_torch.native`, the host CPU), chunked, each chunk
  warm-started from the last draw and seeded ``seed * 100003 + done``
  (``funnel_transient.py:40-94``);
* ``scan`` (default; ``xla``, the JAX harness's name, is accepted as
  an alias): a batch of chains on the scan engine on ``--device``,
  chunked, each chunk resuming the last one's state with the key
  ``fold_in(PRNGKey(1), done)`` (``funnel_transient.py:112-187``).

Each chunk's record goes to the JSON at once, as in the JAX harness;
the JSON adds the card's name and power limit (``card``), the wall so
far (``seconds``) and ``s_per_transition``.  The device is resolved for
both engines, so without a card and without ``--device cpu`` the
harness raises even for ``--engine native``.

Usage, on the card (``--device cpu`` runs it on the CPU)::

    python -m walnuts_tpu_torch.examples.funnel_transient --engine native \\
        --seed 1 --iters 1200 --out out_funnel_transient_native_s1.json
    python -m walnuts_tpu_torch.examples.funnel_transient [--chains 16] \\
        [--iters 1000] [--dtype float64]
"""

import argparse

import numpy as np
import torch

from .. import native
from ..ops import IntegratorConfig
from ..sampler import WalnutsConfig, WarmupConfig, run_walnuts
from ..targets import funnel
from ..utils import threefry
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .common import add_device_flag, atomic_dump, card_name, clock

DIM = 11
M = 12
H0 = DELTA0 = 0.3
OMEGA0 = -30.0
RECOVERED = -5.0
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def native_chunk_seed(seed, done):
    """The native engine's seed for the chunk that starts at ``done``."""
    return seed * 100003 + done


def run_native(*, seed, iters, chunk, max_c, out=None, log=print,
               extra=None):
    """The JAX harness's ``native_main`` (``funnel_transient.py:40-94``):
    a chunked single float64 chain on the host CPU.  Writes the record
    (with ``extra`` merged in) to ``out`` after every chunk and returns
    it."""
    q = np.zeros(DIM)
    q[0] = OMEGA0
    draws, diags = [], []
    done = 0
    t0 = clock("cpu")
    while done < iters:
        n = min(chunk, iters - done)
        d, _, dg = native.run(
            "funnel", DIM, q, n, h0=H0, delta=DELTA0, m=M, min_c=0,
            max_c=max_c, seed=native_chunk_seed(seed, done), want_diag=True)
        draws.append(d)
        diags.append(dg)
        q = d[-1]
        done += n
        w = np.concatenate(draws)[:, 0]
        dg_all = np.concatenate(diags)
        rec = {
            "engine": "native_cpp",
            "dtype": "float64",
            "seed": seed,
            "iters_done": done,
            "max_c": max_c,
            "omega_trace": w[:400].tolist(),
            "orbit_omega_min": dg_all[:400, 2].tolist(),
            "orbit_omega_max": dg_all[:400, 3].tolist(),
            "micro_h_min": (0.3 * 2.0 ** -dg_all[:400, 1]).tolist(),
            "micro_h_max": (0.3 * 2.0 ** -dg_all[:400, 0]).tolist(),
            "orbit_energy_error": dg_all[:400, 4].tolist(),
            "grad_evals_per_iter": dg_all[:400, 5].tolist(),
            "max_if_reached": float(dg_all[:, 1].max()),
        }
        above = w > RECOVERED
        rec["iters_to_recovery"] = int(np.argmax(above)) if above.any() else -1
        if rec["iters_to_recovery"] >= 0:
            tail = w[rec["iters_to_recovery"] + 50:]
            if tail.size >= 50:
                rec["omega_sd_post_recovery"] = float(tail.std())
                rec["omega_mean_post_recovery"] = float(tail.mean())
        seconds = clock("cpu") - t0
        rec.update(extra or {}, seconds=seconds, s_per_transition=seconds / done,
                   grad_evals_total=float(dg_all[:, 5].sum()))
        if out is not None:
            atomic_dump(rec, out)
        log(f"iters={done} omega={w[-1]:.2f} "
            f"rec_iter={rec['iters_to_recovery']}")
    return rec


def scan_chunk_key(done):
    """The scan engine's key for the chunk that starts at ``done``."""
    return threefry.fold_in(threefry.PRNGKey(1), done)


def start(chains, dtype):
    q0 = torch.zeros((chains, DIM), dtype=dtype)
    q0[:, 0] = OMEGA0
    return q0


def run_scan_chunks(*, chains, iters, chunk, max_c, dtype=torch.float32,
                    device=DEFAULT_DEVICE):
    """The JAX harness's chunks (``funnel_transient.py:132-149``), one
    at a time: yields ``(done, samples, diags, state, omin, omax)``."""
    dev = resolve_device(device)
    cfg = WalnutsConfig(m=M, record_orbit_stats=True,
                        igr=IntegratorConfig(min_c=0, max_c=max_c))
    wu = WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    q0 = start(chains, dtype)
    state = None
    done = 0
    while done < iters:
        n = min(chunk, iters - done)
        samples, diags, state, omin, omax = run_walnuts(
            scan_chunk_key(done), q0, target=funnel(DIM), cfg=cfg,
            warmup=wu, num_iter=n, h0=H0, delta0=DELTA0,
            collect_orbit_stats=True, resume_state=state, device=dev)
        done += n
        yield done, samples, diags, state, omin, omax


def run_scan(*, chains, iters, chunk, max_c, dtype=torch.float32,
             device=DEFAULT_DEVICE, out=None, log=print, extra=None):
    """The JAX harness's scan-engine arm (``funnel_transient.py:112-
    187``): writes the record (with ``extra`` merged in) to ``out``
    after every chunk and returns it."""
    dev = resolve_device(device)
    ws, omins, omaxs, if_mins, if_maxs, eerrs, grads = ([] for _ in range(7))
    t0 = clock(dev)
    for done, samples, diags, _, omin, omax in run_scan_chunks(
            chains=chains, iters=iters, chunk=chunk, max_c=max_c,
            dtype=dtype, device=dev):
        ws.append(np.asarray(samples.cpu().numpy(), np.float64)[1:, :, 0])
        omins.append(np.asarray(omin.cpu().numpy(), np.float64)[..., 0])
        omaxs.append(np.asarray(omax.cpu().numpy(), np.float64)[..., 0])
        dg = np.asarray(diags.cpu().numpy(), np.float64)
        if_mins.append(dg[..., 8])
        if_maxs.append(dg[..., 9])
        eerrs.append(dg[..., 17])
        grads.append(dg[..., 6] + dg[..., 7])
        w = np.concatenate(ws)
        rec = {
            "dtype": str(dtype).replace("torch.", ""),
            "chains": chains,
            "iters_done": done,
            "max_c": max_c,
            # the reference's three panels, first 300 iterations
            "omega_trace_median": np.median(w, axis=1)[:300].tolist(),
            "omega_trace_chain0": w[:300, 0].tolist(),
            "orbit_omega_min_chain0": np.concatenate(omins)[:300, 0].tolist(),
            "orbit_omega_max_chain0": np.concatenate(omaxs)[:300, 0].tolist(),
            "micro_h_min_chain0": (
                0.3 * 2.0 ** -np.concatenate(if_maxs)[:300, 0]).tolist(),
            "micro_h_max_chain0": (
                0.3 * 2.0 ** -np.concatenate(if_mins)[:300, 0]).tolist(),
            "orbit_energy_error_median":
                np.median(np.concatenate(eerrs), axis=1)[:300].tolist(),
        }
        # recovery: first iteration with omega > -5, per chain
        above = w > RECOVERED
        rec["iters_to_recovery"] = [
            int(np.argmax(above[:, c])) if above[:, c].any() else -1
            for c in range(chains)]
        rec["recovered_fraction"] = float(
            np.mean([r >= 0 for r in rec["iters_to_recovery"]]))
        # stationary check on the recovered tail
        if done >= 400:
            tail = w[300:].ravel()
            rec["omega_sd_post_recovery"] = float(tail.std())
            rec["omega_mean_post_recovery"] = float(tail.mean())
        seconds = clock(dev) - t0
        g = np.concatenate(grads)
        rec.update(extra or {}, seconds=seconds, s_per_transition=seconds / done,
                   grad_evals_max_chain_per_transition=float(
                       g.max(axis=1).mean()))
        if out is not None:
            atomic_dump(rec, out)
        log(f"iters={done} median_omega={np.median(w[-1]):.2f} "
            f"recovered={rec['recovered_fraction']:.2f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m walnuts_tpu_torch.examples.funnel_transient",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--max-c", type=int, default=30)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--engine", default="scan",
                    choices=["scan", "xla", "native"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="walnuts_tpu_torch/examples/"
                                     "out_funnel_transient.json")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    card = card_name()
    print(card, flush=True)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.engine == "native":
        run_native(seed=args.seed, iters=args.iters, chunk=args.chunk,
                   max_c=args.max_c, out=args.out, log=log,
                   extra={"card": card})
    else:
        run_scan(chains=args.chains, iters=args.iters, chunk=args.chunk,
                 max_c=args.max_c, dtype=DTYPES[args.dtype], device=dev,
                 out=args.out, log=log, extra={"card": card})


if __name__ == "__main__":
    main()
