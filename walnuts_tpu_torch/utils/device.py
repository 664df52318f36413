"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

import torch

from .tree import tree_map

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``, with the current card's index where it
    names CUDA without one (so that it compares equal to a tensor's
    ``.device``); raises if it names CUDA and there is no card, so that
    nothing runs on the CPU unless ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, tuple):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def to_device(tree, dev):
    """Move every tensor of a (nested) tuple / NamedTuple to ``dev``;
    other leaves (ints, None) pass through.  The tree lies on one device,
    so it is returned as it is, without a walk, when its first tensor is
    already on ``dev``."""
    first = _first_tensor(tree)
    if first is None or first.device == dev:
        return tree
    return tree_map(
        lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)
