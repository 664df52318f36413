"""walnuts_tpu_torch: the WALNUTS fused engine in PyTorch, with its
round kernel written by hand in CUDA for the NVIDIA H100.

A port of :mod:`walnuts_tpu` (the JAX package, kept as the reference)
that mirrors its subpackage layout and names.  Device and dtype come
from the chains' start positions ``q0``: on a CUDA tensor the engine's
rounds run in ``csrc/round_kernel.cu``, on a CPU tensor in the plain
torch round body.
"""

from . import diagnostics, ops, sampler, targets, utils
from .ops import IntegratorConfig
from .sampler import WalnutsConfig, WarmupConfig, run_walnuts_fused
from .targets import Target

__all__ = [
    "targets",
    "ops",
    "sampler",
    "utils",
    "diagnostics",
    "Target",
    "IntegratorConfig",
    "WalnutsConfig",
    "WarmupConfig",
    "run_walnuts_fused",
]
