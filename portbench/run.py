"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``walnuts_tpu_torch``).  The cell's configuration,
traffic and entry are found by name (:mod:`cell`).  Set-up loads the
traffic's entry (``entries/<entry>.py``), which builds or loads the
program's kernels, makes the inputs on the card from ``--seed`` and
runs one short call of the cell's shape; then the window makes the
entry's calls, each resuming the last one's state, until ``--seconds``
have passed, and ends in ``torch.cuda.synchronize()``.  With ``--trace
1`` the window runs under ``torch.profiler`` and stops after the
check's calls and the traffic's ``trace_calls`` calls more.  After the
window the metric readers (``metrics/<name>.py``) read what the window
did, the program's state is freed, and the plain reference checks the
window's outputs (the entry's check).

The last line of standard output is the result: ``correct``,
``attempted`` (transitions the window completed), ``failed`` (stored
draws that are not finite), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit.  The last lines of standard error repeat the checks.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "walnuts_tpu")
PROGRAM = "walnuts_tpu_torch"


def process_age_s():
    """Seconds since this process started (its start time from
    ``/proc``, to the kernel's clock tick), else since this module was
    imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark must
    not load (compared as whole names)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root):
    """Every build and kernel cache inside the checkout, at fixed
    paths; set before torch is imported."""
    base = Path(root) / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def card_line():
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Window:
    """What the window did, as the metric readers take it."""


def reader_path(metrics_dir, name):
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    the name with its last dotted part taken off, and so on (the reader
    of ``a.b`` serves ``a.b.warmup``, which only names another
    end-to-end metric that it moves)."""
    parts = name.split(".")
    while parts:
        path = metrics_dir / (".".join(parts) + ".py")
        if path.is_file():
            return path
        parts.pop()
    raise FileNotFoundError(f"no reader for metric {name!r} in {metrics_dir}")


def read_metrics(cell, rows, ctx):
    """``{name: {value, unit}}`` of the metric readers that found
    something to read."""
    from inputs import load_module

    out = {}
    for row in rows:
        path = reader_path(cell.metrics_dir, row["name"])
        mod = load_module(path, "portbench_metric_"
                          + path.stem.replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            out[row["name"]] = {"value": float(value), "unit": row["unit"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark); cpu only rehearses a cell")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(HERE))
    from cell import Cell

    cell = Cell(args.workload, root=ROOT)
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        log(f"no program: {ROOT / PROGRAM} is missing")
        return 2
    cache_dirs(ROOT)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark runs on an NVIDIA GPU")
            return 3
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
            return 3
        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device(args.device)
    sys.path.insert(0, str(ROOT))
    from devtrace import Traced
    from inputs import load_module

    # ---- set-up: the entry builds the program's inputs from the seed
    #      and warms the cell's shapes ----
    entry = load_module(HERE / "entries" / f"{cell.run['entry']}.py",
                        "portbench_entry_" + cell.run["entry"]).Entry(
                            cell, args.seed, dev)
    entry.warm()

    # ---- the window ----
    traced = Traced(dev) if args.trace else None
    if traced:
        traced.__enter__()
    t0 = time.perf_counter()
    setup_s = process_age_s()
    try:
        while True:
            entry.call()
            if entry.calls < entry.check_calls:
                continue
            if time.perf_counter() - t0 >= args.seconds or (
                    traced and entry.calls >= entry.check_calls
                    + int(cell.run["trace_calls"])):
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        if traced:
            traced.__exit__(None, None, None)

    # ---- what the window did ----
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    w = Window()
    w.cell, w.run, w.config = cell, cell.run, cell.config
    w.dtype = cell.config["precision"]["dtype"]
    w.setup_s, w.window_s = setup_s, window_s
    entry.read(w)
    w.trace = traced.summary() if traced else None
    metrics = read_metrics(cell, cell.per_layer if args.trace
                           else cell.end_to_end, w)

    # ---- the check, after the program's state is freed ----
    entry.release()
    t_check = time.perf_counter()
    checks, correct, n_draws = entry.check()
    t_check = time.perf_counter() - t_check
    correct = correct and w.failed == 0

    found = forbidden_modules()
    if found:
        log(f"loaded, and must not be: {', '.join(found)}")
        return 4

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": w.transitions,
              "failed": w.failed, "metrics": metrics, "device": device}
    if traced:
        tr = w.trace
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in tr["device_ops"]],
            "idle_gaps": [[n[:160], s] for n, s in tr["idle_gaps"]]}
    result["checks"] = checks
    if dev.type == "cuda":
        log(f"card: {card_line()}")
    log(f"{cell.name} seed {args.seed}: {w.calls} calls, {w.launches} kernel "
        f"launches, {w.segment_launches} segment launches, {w.grads} grads, "
        f"{w.transitions} transitions in {window_s:.3f} s; set-up "
        f"{setup_s:.3f} s; draws per chain {w.it_range[0]}-{w.it_range[1]}; "
        f"check {t_check:.2f} s, {n_draws} draws of its chains compared")
    print(json.dumps(result), flush=True)
    for name, num in checks.items():
        log(f"check {name} {num['value']!r} limit {num['limit']!r}: "
            f"{'pass' if num['value'] <= num['limit'] else 'FAIL'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
