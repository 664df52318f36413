"""Hamiltonian utilities with optional diagonal inverse-mass metric
(``walnuts_tpu/ops/hamiltonian.py``).

All functions are batched: ``q, v`` are ``[..., D]`` and reductions run
over the trailing dimension only.  Inside a dim split
(:func:`..parallel.mesh.dim_split`) ``q, v`` and ``inv_mass`` are this
rank's columns, and every sum over D is the dim group's.
"""

import torch

from ..parallel.mesh import dim_sum
from ..utils import threefry


def kinetic_energy(v, inv_mass=None):
    """``0.5 * v^T M^{-1} v``."""
    if inv_mass is None:
        return 0.5 * dim_sum(torch.sum(v * v, dim=-1))
    return 0.5 * dim_sum(torch.sum(v * inv_mass * v, dim=-1))


def hamiltonian(lp, v, inv_mass=None):
    """``-logp(q) + K(v)`` given a precomputed log density."""
    return -lp + kinetic_energy(v, inv_mass)


def uturn(q_earlier, v_earlier, q_later, v_later, inv_mass=None):
    """Batched U-turn predicate between two phase-space points: ``True``
    where ``v_later . M^{-1}(q_later - q_earlier) < 0`` or the same with
    ``v_earlier``.  The first argument is the temporally earlier state."""
    d = q_later - q_earlier
    if inv_mass is not None:
        d = d * inv_mass
    later, earlier = dim_sum(torch.sum(v_later * d, dim=-1),
                             torch.sum(v_earlier * d, dim=-1))
    return (later < 0.0) | (earlier < 0.0)


def refresh_momentum(key, shape, inv_mass=None, dtype=torch.float32,
                     rows=None, cols=None):
    """Draw ``v ~ N(0, M)`` from the threefry key ``key``
    (``utils.threefry``), on the key's device: JAX's
    ``jax.random.normal(key, shape, dtype)`` with ``inv_mass=None``,
    otherwise ``v = M^{1/2} z`` (``inv_mass`` the ``[D]`` diagonal).
    ``rows=(r0, r1)`` draws rows ``r0 .. r1`` of ``shape``'s leading
    (chain) axis alone, ``cols=(c0, c1)`` columns ``c0 .. c1`` of its
    last axis, with those columns of ``inv_mass``."""
    z = threefry.normal(key, shape, dtype, rows, cols)
    if inv_mass is None:
        return z
    if cols is not None:
        inv_mass = inv_mass[..., cols[0]:cols[1]]
    return z * inv_mass ** -0.5
