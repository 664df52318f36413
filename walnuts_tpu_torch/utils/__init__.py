from .constants import LOG_ZERO, WT_SUM_THRESH
from .p2 import P2State, p2_init, p2_push, p2_quantile

__all__ = [
    "LOG_ZERO",
    "WT_SUM_THRESH",
    "P2State",
    "p2_init",
    "p2_push",
    "p2_quantile",
]
