"""Small helpers over (nested) NamedTuples and tuples of tensors
(``walnuts_tpu/utils/tree.py``)."""

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over matching tuples / NamedTuples."""
    first = trees[0]
    if isinstance(first, tuple):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return fn(*trees)


def tree_where(pred, on_true, on_false):
    """Per-chain select over matching trees: ``pred`` is ``[C]``, leaves
    are ``[C, ...]``; the predicate broadcasts over each leaf's trailing
    dims.  Out of place, so no leaf aliases another."""

    def _sel(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim))
        return torch.where(p, a, b)

    return tree_map(_sel, on_true, on_false)


def tree_stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)
