from .hamiltonian import hamiltonian, kinetic_energy, refresh_momentum, uturn
from .integrators import (INTEGRATORS, IntegratorConfig, IntegratorResult,
                          get_integrator)
from .leapfrog import (STEP_FNS, MultistepResult, PhasePoint,
                       implicit_midpoint_step, leapfrog_flow_step,
                       leapfrog_step, masked_multistep, yoshida_step)

__all__ = [
    "kinetic_energy",
    "hamiltonian",
    "uturn",
    "refresh_momentum",
    "IntegratorConfig",
    "IntegratorResult",
    "INTEGRATORS",
    "get_integrator",
    "PhasePoint",
    "STEP_FNS",
    "MultistepResult",
    "masked_multistep",
    "leapfrog_step",
    "yoshida_step",
    "leapfrog_flow_step",
    "implicit_midpoint_step",
]
