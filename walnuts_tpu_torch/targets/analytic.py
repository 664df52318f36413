"""Analytic example targets (``walnuts_tpu/targets/analytic.py``).

``funnel(D)`` has ``omega ~ N(0, scale^2)`` and ``x_i | omega ~
N(0, e^omega)`` for ``i = 1..D-1``; ``funnel(101)`` is the benchmark's
configuration.  The batched closed forms below follow the JAX version's
operation order, so the two agree to rounding in float64; ``smile``,
``rosenbrock`` and ``mod_funnel`` take their gradients from autograd, as
the JAX version takes them from autodiff.  Constant vectors (the
rescaled funnel's scales, the ill-conditioned Gaussian's variances) are
built in float64 and cast to the position's dtype where they are used.

``std_gauss``, ``ill_conditioned_gauss`` and ``funnel`` are separable and
split on a rank's columns under a dim split (``block_logp_grad``): each
rank sums its own columns and one all-reduce over the dim group joins
the partial sums.  The other targets take ``Target``'s general route.
"""

import math

import torch

from ..parallel.mesh import dim_sum
from .base import Target, constant_like

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

    def block_logp_grad(q, split):
        return -0.5 * dim_sum(torch.sum(q * q, dim=-1)), -q

    return Target(logp, dim, name=f"std_gauss_{dim}", logp_grad=logp_grad,
                  generated=generated, kernel_id="std_gauss",
                  block_logp_grad=block_logp_grad)


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

    def closed_form(w, x, ss):
        e = torch.exp(-w)
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
        return lp, gw, -x * e[..., None]

    def logp_grad(q):
        w, x = q[..., 0], q[..., 1:]
        lp, gw, gx = closed_form(w, x, torch.sum(x * x, dim=-1))
        return lp, torch.cat([gw[..., None], gx], dim=-1)

    def block_logp_grad(q, split):
        # omega lives on the rank with column 0: its column and every
        # rank's partial sum of x^2 go through one all-reduce (the other
        # ranks add zeros to omega); k stays the global D - 1
        head = split.d0 == 0
        x = q[..., 1:] if head else q
        w_part = q[..., 0] if head else torch.zeros_like(q[..., 0])
        w, ss = dim_sum(w_part, torch.sum(x * x, dim=-1))
        lp, gw, gx = closed_form(w, x, ss)
        return lp, (torch.cat([gw[..., None], gx], dim=-1) if head else gx)

    return Target(logp, dim, name=f"funnel_{dim}", logp_grad=logp_grad,
                  generated=generated, kernel_id="funnel", kernel_param=scale,
                  block_logp_grad=block_logp_grad)


def corr_gauss(rho: float = 0.5) -> Target:
    """Bivariate unit-variance normal with correlation ``rho``
    (``targetDistr.py:25-31``)."""
    tmp = 1.0 - rho ** 2

    def logp(q):
        return -0.5 * q[0] ** 2 - (0.5 / tmp) * (q[1] - rho * q[0]) ** 2

    def logp_grad(q):
        q0, q1 = q[..., 0], q[..., 1]
        lp = -0.5 * q0 ** 2 - (0.5 / tmp) * (q1 - rho * q0) ** 2
        g = torch.stack([-(q0 - rho * q1) / tmp, -(q1 - rho * q0) / tmp],
                        dim=-1)
        return lp, g

    return Target(logp, 2, name=f"corr_gauss_rho{rho}", logp_grad=logp_grad)


def smile() -> Target:
    """``q0 ~ N(0, 1)``, ``q1 | q0 ~ N(q0^2, 1)`` (``targetDistr.py:34-38``)."""

    def logp(q):
        return -0.5 * q[0] ** 2 - 0.5 * (q[1] - q[0] ** 2) ** 2

    return Target(logp, 2, name="smile")


def rosenbrock() -> Target:
    """Rosenbrock-shaped density (``test/targets.py:14-21``)."""

    def logp(q):
        return -0.5 * q[0] ** 2 - 0.5 * (q[1] - q[0] ** 2) ** 2 / 0.19 ** 2

    return Target(logp, 2, name="rosenbrock")


def mod_funnel() -> Target:
    """Smoothed 2-D funnel with bounded curvature
    (``targetDistr.py:41-51``)."""

    def logp(q):
        x, y = q[0], q[1]
        t2 = 1.0 + torch.exp(-3.0 * x)
        return -0.5 * (t2 * y ** 2 + torch.log(1.0 / t2) + x ** 2)

    return Target(logp, 2, name="mod_funnel")


def funnel_rescaled(dim: int, scale: float = 3.0) -> Target:
    """Funnel with the omega coordinate pre-scaled to unit prior sd
    (``targetDistr.py:81-86``)."""
    base = funnel(dim, scale)
    s64 = torch.ones(dim, dtype=torch.float64)
    s64[0] = scale
    s_for = constant_like(s64)

    def logp(q):
        return base._logp(s_for(q) * q)

    def logp_grad(q):
        s = s_for(q)
        lp, g = base.logp_grad(s * q)
        return lp, s * g

    return Target(logp, dim, name=f"funnel_rescaled_{dim}",
                  logp_grad=logp_grad)


def ill_conditioned_gauss(dim: int, kappa: float = 1e4) -> Target:
    """Diagonal Gaussian with log-linearly spaced variances in
    ``[1, kappa]``."""
    var64 = 10.0 ** torch.linspace(0.0, math.log10(kappa), dim,
                                   dtype=torch.float64)
    var_for = constant_like(var64)

    def logp(q):
        return -0.5 * torch.sum(q * q / var_for(q))

    def logp_grad(q):
        var = var_for(q)
        return -0.5 * torch.sum(q * q / var, dim=-1), -q / var

    def block_logp_grad(q, split):
        var = var_for(q)[split.d0:split.d1]
        return -0.5 * dim_sum(torch.sum(q * q / var, dim=-1)), -q / var

    return Target(logp, dim, name=f"ill_gauss_{dim}_k{kappa:g}",
                  logp_grad=logp_grad, block_logp_grad=block_logp_grad)
