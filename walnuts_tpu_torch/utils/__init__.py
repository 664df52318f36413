from . import threefry
from .checkpoint import load_state, save_state
from .constants import ISOKINETIC_DELTA_THRESH, LOG_ZERO, WT_SUM_THRESH
from .device import resolve_device
from .dual_average import DualAverageState, da_init, da_observe, da_par
from .p2 import P2State, p2_init, p2_push, p2_quantile
from .tree import tree_stack, tree_where

__all__ = [
    "LOG_ZERO",
    "WT_SUM_THRESH",
    "ISOKINETIC_DELTA_THRESH",
    "P2State",
    "p2_init",
    "p2_push",
    "p2_quantile",
    "DualAverageState",
    "da_init",
    "da_observe",
    "da_par",
    "threefry",
    "tree_where",
    "tree_stack",
    "save_state",
    "load_state",
    "resolve_device",
]
