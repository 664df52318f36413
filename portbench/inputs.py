"""What a cell hands to the program and to the reference: the targets,
the chains' start and tuning drawn from ``--seed``, the sampler
configuration and the engine's keyword arguments."""

import importlib.util
import json
from pathlib import Path

import torch

from cell import HERE

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def hash_seed(seed):
    """The engine's int32 hash seed for ``--seed``."""
    return int(seed) % (2 ** 31 - 1)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_target(cell):
    """The plain reference of the configuration's target, the module
    ``reference/<target name>.py``."""
    t = cell.config["target"]
    mod = load_module(HERE / "reference" / f"{t['name']}.py",
                      f"portbench_reference_{t['name']}")
    return mod.build(t.get("args", {}), cell.root)


def _resolve(args, root):
    """Arguments ending in ``_path`` are relative to the checkout."""
    return {k: (str(Path(root) / v) if k.endswith("_path") else v)
            for k, v in args.items()}


def program_target(cell, tw):
    """The program's target: its factory ``walnuts_tpu_torch.targets.
    <name>`` with the configuration's arguments and summary; on the
    ``external`` route the same density handed over as a user's target
    (no fused gradient)."""
    t = cell.config["target"]
    args = _resolve(t.get("args", {}), cell.root)
    summary = cell.run["summary"].get("program")
    if summary is not None:
        args["generated"] = getattr(tw.targets, summary)
    target = getattr(tw.targets, t["name"])(**args)
    if cell.run["route"] == "external":
        target = tw.Target(target._logp, target.dim,
                           name=f"{target.name}_user",
                           logp_grad=target._logp_grad,
                           generated=target._generated)
    elif cell.run["route"] != "fused":
        raise ValueError(f"unknown route {cell.run['route']!r}")
    return target


def start(cell, ref, seed, device):
    """``(q0 [C, D], h [C], delta [C])`` on ``device``: ``exact`` draws of
    the target, or ``center`` plus ``scale`` standard normals
    (``center``: ``zeros`` or a file under this folder holding ``{"q":
    [...]}``).  The set of starting points is drawn once from the start's
    ``set_seed``; ``seed`` deals them to the chains in its own order, so
    that every seed gives the same work."""
    run = cell.run
    dtype = DTYPES[cell.config["precision"]["dtype"]]
    C, D = int(run["chains"]), ref.dim
    sp = run["start"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(sp["set_seed"]))
    if sp["kind"] == "exact":
        q0 = ref.exact(gen, C, dtype, device)
    elif sp["kind"] == "jitter":
        z = torch.randn((C, D), generator=gen, device=device,
                        dtype=torch.float32)
        if sp["center"] == "zeros":
            center = torch.zeros(D, device=device)
        else:
            center = torch.tensor(
                json.loads((HERE / sp["center"]).read_text())["q"],
                dtype=torch.float32, device=device)
        q0 = (center[None] + float(sp["scale"]) * z).to(dtype)
    else:
        raise ValueError(f"unknown start {sp['kind']!r}")
    deal = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    q0 = q0[torch.randperm(C, generator=deal).to(device)]
    tu = run["tuning"]
    h = torch.full((C,), float(tu["h"]), dtype=dtype, device=device)
    delta = torch.full((C,), float(tu["delta"]), dtype=dtype, device=device)
    return q0, h, delta


def engine_kwargs(cell, tw, target, device):
    """Keyword arguments of ``run_walnuts_fused`` for one call of the
    cell's round cap."""
    run, smp = cell.run, cell.config["sampler"]
    igr = tw.ops.IntegratorConfig(**{k: smp[k] for k in
                                     ("min_c", "max_c", "r2p_prob0")
                                     if k in smp})
    cfg = tw.WalnutsConfig(m=int(smp["m"]), integrator=smp["integrator"],
                           igr=igr,
                           step_size_rand_scale=float(
                               smp.get("step_size_rand_scale", 0.2)))
    wu = run.get("warmup")
    return dict(target=target, cfg=cfg, num_iter=int(run["num_iter"]),
                stop_mode=run["stop_mode"],
                warmup=tw.WarmupConfig(**wu) if wu else None,
                ring_rows=int(run["ring_rows"]),
                diag_rows=int(run["diag_rows"]),
                micro_unroll=int(run["micro_unroll"]),
                rounds=int(run["rounds_per_call"]), device=device)


def sample_ids(seed, C, n):
    """The chains the check follows, drawn from ``seed``."""
    gen = torch.Generator().manual_seed((int(seed) + 0x5EED) % 2 ** 63)
    return torch.sort(torch.randperm(C, generator=gen)[:n]).values
