from .analytic import (corr_gauss, funnel, funnel_rescaled,
                       ill_conditioned_gauss, mod_funnel, omega_sumsq,
                       rosenbrock, smile, std_gauss)
from .base import Target

__all__ = ["Target", "std_gauss", "corr_gauss", "smile", "rosenbrock",
           "mod_funnel", "funnel", "funnel_rescaled", "ill_conditioned_gauss",
           "omega_sumsq"]
