"""walnuts_tpu_torch: WALNUTS in PyTorch for the NVIDIA H100.

A port of :mod:`walnuts_tpu` (the JAX package, kept as the reference)
that mirrors its subpackage layout and names.  Three WALNUTS engines:

* :func:`run_walnuts`, the scan engine: any of the seven integrators,
  warmup adaptation, full diagnostics, JAX's threefry random stream;
* :func:`sampler.run_walnuts_streaming`, the streaming engine: the same
  transition at fixed tuning, with every chain on its own schedule
  position so that no chain waits at a transition barrier;
* :func:`run_walnuts_fused`, the fused engine, whose rounds run in the
  hand-written CUDA kernel ``csrc/round_kernel.cu``.

the isokinetic line: the step kernels ``sampler.IsokineticKernel``
and ``sampler.HMCKernel`` (``ops.isokinetic``), generic-step NUTS
(``sampler.run_generic_nuts``) and the fixed-orbit multinomial sampler
with the WASPS stop (``sampler.run_multinomial``); the paper-pseudocode
mode (``sampler.walnuts_pseudo``) and the Monge-metric integrators
(``ops.monge``).  The targets include Stock-Watson
(``targets.stock_watson``), whose gradient the round kernel fuses.

Chains split over ``torch.distributed`` ranks through :mod:`.parallel`
(``mesh=`` on ``run_walnuts`` and ``run_walnuts_fused``); :mod:`.native`
loads the native C++ engine, the CPU oracle; :mod:`.entry` holds the
counterparts of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``.

Every entry runs on the card unless the caller passes ``device="cpu"``
(the fused engine's CPU path is the kernel's plain torch twin); without
a card the default raises.  ``walnuts_transition``, the step functions
and the ops run on their inputs' device.  dtype comes from ``q0``.
"""

from . import diagnostics, entry, native, ops, parallel, sampler, targets, utils
from .ops import IntegratorConfig, get_integrator
from .sampler import (SamplerState, WalnutsConfig, WarmupConfig, run_walnuts,
                      run_walnuts_fused, walnuts_transition)
from .targets import Target

__all__ = [
    "targets",
    "ops",
    "sampler",
    "utils",
    "diagnostics",
    "parallel",
    "native",
    "entry",
    "Target",
    "IntegratorConfig",
    "get_integrator",
    "WalnutsConfig",
    "WarmupConfig",
    "SamplerState",
    "walnuts_transition",
    "run_walnuts",
    "run_walnuts_fused",
]
