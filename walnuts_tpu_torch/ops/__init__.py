from . import isokinetic, monge
from .hamiltonian import hamiltonian, kinetic_energy, refresh_momentum, uturn
from .integrators import (INTEGRATORS, IntegratorConfig, IntegratorResult,
                          adapt_implicit_midpoint_d, adapt_leapfrog_d,
                          adapt_leapfrog_flow_d, adapt_leapfrog_r2p,
                          adapt_rescaled_leapfrog_d, adapt_yoshida_d,
                          fixed_leapfrog, get_integrator)
from .leapfrog import (STEP_FNS, MultistepResult, PhasePoint,
                       implicit_midpoint_step, leapfrog_flow_step,
                       leapfrog_step, masked_multistep, yoshida_step)

__all__ = [
    "isokinetic",
    "monge",
    "kinetic_energy",
    "hamiltonian",
    "uturn",
    "refresh_momentum",
    "IntegratorConfig",
    "IntegratorResult",
    "INTEGRATORS",
    "get_integrator",
    "fixed_leapfrog",
    "adapt_leapfrog_d",
    "adapt_yoshida_d",
    "adapt_leapfrog_flow_d",
    "adapt_leapfrog_r2p",
    "adapt_implicit_midpoint_d",
    "adapt_rescaled_leapfrog_d",
    "PhasePoint",
    "STEP_FNS",
    "MultistepResult",
    "masked_multistep",
    "leapfrog_step",
    "yoshida_step",
    "leapfrog_flow_step",
    "implicit_midpoint_step",
]
