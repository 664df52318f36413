"""Adaptive macro-step integrator configuration
(``walnuts_tpu/ops/integrators.py:57-67``).

Only the static tuning record is ported so far: the fused engine runs
its leapfrog R2P/D protocols inline.  The integrator functions
themselves are ROADMAP queue 1 item 8.
"""

from typing import NamedTuple


class IntegratorConfig(NamedTuple):
    """Static tuning record (reference ``integratorAuxPar``)."""

    min_c: int = 0
    max_c: int = 10
    r2p_prob0: float = 2.0 / 3.0
    max_fp_iter: int = 30
    fp_tol: float = 1.0e-8
    fp_newton: bool = False
    rescaled_grad_thresh: float = 5.0
