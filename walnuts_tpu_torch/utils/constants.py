"""Numeric sentinels shared across the port
(``walnuts_tpu/utils/constants.py``).

``LOG_ZERO`` is "this multinomial weight is numerically zero" in log
space; ``WT_SUM_THRESH`` guards the online categorical update against an
all-dead weight sum.  ``WT_SUM_THRESH`` is below float32's smallest
subnormal, so cast to float32 it becomes exactly 0.0: every comparison
against it casts it to the run dtype first.
"""

LOG_ZERO = -700.0
WT_SUM_THRESH = 2.7189761758644324e-304  # exp(LOG_ZERO + 1)

# Isokinetic blow-up guard: a B-kick's rapidity ``h |g| / (2 (d - 1))``
# above it marks the step as failed (``isokinetic/microCanonical.py:12``).
ISOKINETIC_DELTA_THRESH = 100.0
