from .driver import WarmupConfig
from .megakernel import (MState, mstate_from_numpy, mstate_to_numpy,
                         run_walnuts_fused)
from .transition import WalnutsConfig

__all__ = [
    "WalnutsConfig",
    "WarmupConfig",
    "MState",
    "mstate_from_numpy",
    "mstate_to_numpy",
    "run_walnuts_fused",
]
