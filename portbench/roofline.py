"""Peaks of one NVIDIA H100 SXM and the work-counted roofline of a
window.

The bound is counted from the work the window did and the cell's shape,
never from the launches the program chose or the layout of its state:
a faster implementation moves the same work, so no implementation can
read above 100% of it.

- Operations: the gradient evaluations times D times the target's
  float operations per coordinate of one micro step (its leapfrog
  update, kinetic energy and gradient; the configuration states the
  count).
- Bytes: the draws written (summary width each), plus each chain's
  position and momentum (D values each) and its step-size state (H and
  delta) read once and written once per window.
- The bound is the larger of the two times at the peaks below.
"""

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth and the vector (not
# tensor-core) float rates, at the card's full 700 W.
HBM_BYTES_S = 3.35e12
FLOP_S = {"float32": 67e12, "float64": 34e12}


def work(C, D, itemsize, dg, grads, draws, flops_per_coord):
    """``(operations, bytes)`` of a window over ``C`` chains in ``D``
    dimensions that made ``grads`` gradient evaluations and stored
    ``draws`` draws of width ``dg``."""
    ops = float(grads) * D * flops_per_coord
    state = C * (2 * D + 2) * itemsize
    nbytes = 2.0 * state + float(draws) * dg * itemsize
    return ops, nbytes


def bound_s(ops, nbytes, dtype):
    """The least time the chip could take for that work."""
    return max(ops / FLOP_S[dtype], nbytes / HBM_BYTES_S)
