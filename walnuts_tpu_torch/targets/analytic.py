"""Analytic example targets (``walnuts_tpu/targets/analytic.py``).

``funnel(D)`` has ``omega ~ N(0, scale^2)`` and ``x_i | omega ~
N(0, e^omega)`` for ``i = 1..D-1``; ``funnel(101)`` is the benchmark's
configuration.  The batched closed forms below follow the JAX version's
operation order, so the two agree to rounding in float64.  The rest of
the JAX module's targets are ROADMAP queue 1 item 2.
"""

import math

import torch

from .base import Target

_LOG_2PI = math.log(2.0 * math.pi)


def omega_sumsq(q):
    """The benchmark's stored summary ``(omega, sum x^2)`` of a funnel
    position; the CUDA round kernel computes it in place."""
    return torch.stack([q[..., 0], torch.sum(q[..., 1:] ** 2, dim=-1)], dim=-1)


def std_gauss(dim: int, generated=None) -> Target:
    """IID standard normal (``targetDistr.py:18-21``)."""

    def logp(q):
        return -0.5 * torch.sum(q * q)

    def logp_grad(q):
        lp = -0.5 * torch.sum(q * q, dim=-1)
        return lp, -q

    return Target(logp, dim, name=f"std_gauss_{dim}", logp_grad=logp_grad,
                  generated=generated, kernel_id="std_gauss")


def funnel(dim: int, scale: float = 3.0, generated=None) -> Target:
    """Neal's funnel in ``dim`` dimensions: ``q[0] = omega ~ N(0,
    scale^2)``; ``q[1:] | omega ~ N(0, e^omega)``.  The exact omega
    marginal is the validation invariant."""
    k = dim - 1

    def logp(q):
        w = q[0]
        x = q[1:]
        z = w / scale
        return (-0.5 * z * z - math.log(scale) - 0.5 * _LOG_2PI) + torch.sum(
            -0.5 * x * x * torch.exp(-w) - 0.5 * w - 0.5 * _LOG_2PI)

    def logp_grad(q):
        w = q[..., 0]
        x = q[..., 1:]
        e = torch.exp(-w)
        ss = torch.sum(x * x, dim=-1)
        z = w / scale
        lp = (
            -0.5 * (z * z)
            - math.log(scale)
            - 0.5 * _LOG_2PI
            - 0.5 * e * ss
            - 0.5 * k * w
            - 0.5 * k * _LOG_2PI
        )
        gw = -w / scale ** 2 + 0.5 * e * ss - 0.5 * k
        gx = -x * e[..., None]
        return lp, torch.cat([gw[..., None], gx], dim=-1)

    return Target(logp, dim, name=f"funnel_{dim}", logp_grad=logp_grad,
                  generated=generated, kernel_id="funnel", kernel_param=scale)
