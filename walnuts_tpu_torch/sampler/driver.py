"""Warmup configuration (``walnuts_tpu/sampler/driver.py:32-54``).

The scan driver itself is ROADMAP queue 1 item 9; the fused engine
(:mod:`.megakernel`) runs this warmup in-loop.
"""

from typing import NamedTuple


class WarmupConfig(NamedTuple):
    """Static warmup configuration (defaults of ``WALNUTS.py:115-127``).

    ``pooled=True`` replaces each chain's tuning by the batch median of
    the per-chain adaptation statistics, so every chain shares one
    ``(H, delta)``.
    """

    warmup_iter: int = 1000
    adapt_h: bool = True
    adapt_h_target: float = 0.8
    adapt_delta: bool = True
    adapt_delta_target: float = 0.6
    adapt_delta_quantile: float = 0.9
    pooled: bool = False
