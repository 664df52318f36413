from .driver import (SamplerState, WarmupConfig, init_state, masked_quantile,
                     run_walnuts, sampler_state_from_numpy,
                     sampler_state_to_numpy, sampler_step)
from .generic_nuts import DIAG_COLS as GENERIC_DIAG_COLS
from .generic_nuts import generic_nuts_transition, run_generic_nuts
from .kernels import HMCKernel, IsokineticKernel
from .megakernel import (MState, mstate_from_numpy, mstate_to_numpy,
                         run_walnuts_fused, run_walnuts_fused_plain)
from .multinomial import MultinomialConfig, run_multinomial
from .plans import OrbitSchedule, build_schedule, subtree_checks
from .pseudocode import (PseudoResult, choose_micro_steps, micro_steps_logp,
                         stable_steps, walnuts_pseudo, walnuts_step_pseudo)
from .streaming import run_walnuts_streaming
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
    "run_walnuts_streaming",
    "IsokineticKernel",
    "HMCKernel",
    "generic_nuts_transition",
    "run_generic_nuts",
    "GENERIC_DIAG_COLS",
    "MultinomialConfig",
    "run_multinomial",
    "PseudoResult",
    "stable_steps",
    "choose_micro_steps",
    "micro_steps_logp",
    "walnuts_step_pseudo",
    "walnuts_pseudo",
]
