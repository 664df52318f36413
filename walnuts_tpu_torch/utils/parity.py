"""The float64 parity contracts that hold the port against the JAX
package (and a CUDA kernel against its plain twin).

* ``EXACT``: runs without adaptation.  Integer state equal, floats
  within rtol 1e-9 / atol 1e-12.  The float bits do differ: a sum over
  D is taken in other orders (XLA's CPU backend sums a short row in
  sequence and a long one in vector lanes, torch in neither order, the
  kernel in a warp butterfly), and XLA fuses multiplies into adds.
* ``ADAPTIVE``: runs whose warmup adapts H and delta.  Integer state
  equal, floats within rtol 1e-8 / atol 1e-9.  The adaptation reads
  energy differences (``max|dH|`` for H, the orbit's energy range for
  delta), which magnify those last-bit differences by the ratio of the
  energy to its increments: the adapted H and delta differ by ~1e-12
  relative, and every later step integrates with them.  One diagnostic
  is held looser there (``ENERGY_RANGE``): column 17, the orbit's
  energy range ``h_max - h_min``, is a difference of two energies, so
  its absolute error follows the energies, not the range (1.8e-8
  against a range of 0.25 measured, funnel(5)).

  ``ADAPTIVE`` is a short-horizon contract.  A trajectory's sensitivity
  to its step size amplifies the H difference from one iteration to the
  next, so no fixed float tolerance holds over a long warmup, and in
  the end an integer decision flips too.  Measured (``drift_survey`` in
  ``tests/test_torch_scan_engine.py``) on funnel(5), 16
  chains, m=5, 15 warmup of 25 iterations, PRNGKey(1..8), per-chain and
  pooled: integers equal in all 16 runs; floats within ``ADAPTIVE`` in
  15 (worst: 0.97 of the bound, PRNGKey(3) per-chain) and column 17
  within 0.67 of ``ENERGY_RANGE``.  Under PRNGKey(7) per-chain one
  chain's difference grows ~3x per iteration from iteration 21 and
  passes the bound at iteration 25 (samples 3.0x, gradient 11.8x).

A statistic that multiplies a small difference of O(1) terms by a known
factor is held with that factor on the atol.  The isokinetic steps'
``c_obs = |err| n^2 / h^3`` is one: ``err = lp - W + H0`` cancels terms
of order one, ``W`` sums the log-Jacobians of up to 2^c micro steps, and
its last bits follow the order of that sum (measured: ``err`` within
7e-14 of JAX's, 4e-8 relative at ``err`` ~ 1e-6; held with atol
``1e-12 n^2 / h^3``, ``tests/test_torch_isokinetic.py``).
"""

import numpy as np

EXACT = dict(rtol=1e-9, atol=1e-12)
ADAPTIVE = dict(rtol=1e-8, atol=1e-9)
ENERGY_RANGE = dict(rtol=1e-7, atol=1e-9)
ENERGY_RANGE_COL = 17


def assert_parity(want, got, contract=EXACT, label=""):
    """``got`` against ``want`` (array-likes): integer and bool arrays
    equal, float arrays within ``contract``."""
    want = np.asarray(want)
    got = np.asarray(got)
    assert want.shape == got.shape, (label, want.shape, got.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=label)
    else:
        np.testing.assert_allclose(got, want.astype(np.float64),
                                   err_msg=label, **contract)
