"""Static sampler configuration (``walnuts_tpu/sampler/transition.py:53-64``).

The scan engine's transition itself is ROADMAP queue 1 item 9.
"""

from typing import NamedTuple

from ..ops.integrators import IntegratorConfig


class WalnutsConfig(NamedTuple):
    """Static sampler configuration (keyword surface of
    ``WALNUTSpy/WALNUTS.py:111-129``)."""

    m: int = 10
    integrator: str = "adapt_leapfrog_r2p"
    igr: IntegratorConfig = IntegratorConfig()
    step_size_rand_scale: float = 0.2
    record_orbit_stats: bool = False
    use_inv_mass: bool = False  # identity metric by default (WALNUTSpy)
