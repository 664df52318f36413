from .hamiltonian import hamiltonian, kinetic_energy, refresh_momentum, uturn
from .integrators import IntegratorConfig

__all__ = [
    "kinetic_energy",
    "hamiltonian",
    "uturn",
    "refresh_momentum",
    "IntegratorConfig",
]
