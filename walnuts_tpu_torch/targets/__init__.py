from .analytic import funnel, omega_sumsq, std_gauss
from .base import Target

__all__ = ["Target", "std_gauss", "funnel", "omega_sumsq"]
