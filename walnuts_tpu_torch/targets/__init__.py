from .analytic import (corr_gauss, funnel, funnel_rescaled,
                       ill_conditioned_gauss, mod_funnel, omega_sumsq,
                       rosenbrock, smile, std_gauss)
from .base import Target
from .stock_watson import load_sw_data, stock_watson

__all__ = ["Target", "std_gauss", "corr_gauss", "smile", "rosenbrock",
           "mod_funnel", "funnel", "funnel_rescaled", "ill_conditioned_gauss",
           "omega_sumsq", "stock_watson", "load_sw_data"]
