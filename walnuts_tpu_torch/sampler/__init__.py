from .driver import (SamplerState, WarmupConfig, init_state, masked_quantile,
                     run_walnuts, sampler_state_from_numpy,
                     sampler_state_to_numpy, sampler_step)
from .megakernel import (MState, mstate_from_numpy, mstate_to_numpy,
                         run_walnuts_fused, run_walnuts_fused_plain)
from .plans import OrbitSchedule, build_schedule, subtree_checks
from .transition import TransitionResult, WalnutsConfig, walnuts_transition

__all__ = [
    "WalnutsConfig",
    "WarmupConfig",
    "SamplerState",
    "init_state",
    "sampler_step",
    "walnuts_transition",
    "TransitionResult",
    "masked_quantile",
    "build_schedule",
    "subtree_checks",
    "OrbitSchedule",
    "run_walnuts",
    "sampler_state_from_numpy",
    "sampler_state_to_numpy",
    "MState",
    "mstate_from_numpy",
    "mstate_to_numpy",
    "run_walnuts_fused",
    "run_walnuts_fused_plain",
]
