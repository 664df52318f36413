from . import threefry
from .checkpoint import load_state, save_state
from .constants import LOG_ZERO, WT_SUM_THRESH
from .device import resolve_device
from .p2 import P2State, p2_init, p2_push, p2_quantile
from .tree import tree_stack, tree_where

__all__ = [
    "LOG_ZERO",
    "WT_SUM_THRESH",
    "P2State",
    "p2_init",
    "p2_push",
    "p2_quantile",
    "threefry",
    "tree_where",
    "tree_stack",
    "save_state",
    "load_state",
    "resolve_device",
]
