"""Hamiltonian utilities with optional diagonal inverse-mass metric
(``walnuts_tpu/ops/hamiltonian.py``).

All functions are batched: ``q, v`` are ``[..., D]`` and reductions run
over the trailing dimension only.
"""

import torch


def kinetic_energy(v, inv_mass=None):
    """``0.5 * v^T M^{-1} v``."""
    if inv_mass is None:
        return 0.5 * torch.sum(v * v, dim=-1)
    return 0.5 * torch.sum(v * inv_mass * v, dim=-1)


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
    return ((torch.sum(v_later * d, dim=-1) < 0.0)
            | (torch.sum(v_earlier * d, dim=-1) < 0.0))


def refresh_momentum(generator, shape, inv_mass=None, dtype=torch.float32,
                     device=None):
    """Draw ``v ~ N(0, M)`` from ``generator`` (a ``torch.Generator`` on
    ``device``): a standard-normal refresh with ``inv_mass=None``,
    otherwise ``v = M^{1/2} z``."""
    z = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    if inv_mass is None:
        return z
    return z * inv_mass ** -0.5
