"""What the port's example harnesses share: the ``--device`` flag, the
card's stamp, a wall clock that waits for the card, the cuts of a run
and the atomic JSON write."""

import json
import os
import subprocess
import time

import torch

from ..utils.device import DEFAULT_DEVICE


def add_device_flag(ap):
    """``--device``: the card unless the caller passes ``--device cpu``
    (``resolve_device(args.device)`` raises if it names the card and
    there is none)."""
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the engine runs: the card (default) or "
                         "'cpu'; without a card only 'cpu' runs")


def card_name():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: unavailable"
    return out[0] if out else "nvidia-smi: unavailable"


def clock(dev) -> float:
    """``time.perf_counter()`` once the card has finished its queued
    work (on the CPU, at once)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def cuts(ap, args, names):
    """``{flag: {"default": d, "run": v}}`` for each of ``names`` (the
    harness's depth flags) whose value is below the parser's default:
    the run's ``reduced`` key."""
    out = {}
    for name in names:
        default, value = ap.get_default(name), getattr(args, name)
        if value < default:
            out[name] = {"default": default, "run": value}
    return out


def atomic_dump(obj, path):
    """Write ``obj`` as JSON to ``path`` through a temporary file, so a
    reader never sees half a file."""
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(tmp, path)
