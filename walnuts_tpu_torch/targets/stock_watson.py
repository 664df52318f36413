"""Stock-Watson stochastic-volatility model
(``walnuts_tpu/targets/stock_watson.py``).

The reference's only real-data model (``sw_innov.stan``): a
non-centered random-walk state space over the ``T = 252`` rows of
``examples/data/swdata.json``, read here by path.

Unconstrained parameter layout (Stan declaration order),
``D = 3T``::

    [tSigma, z1, zinn[T-2], x1, xinn[T-1], tau1, tauinn[T-1]]

Model::

    sigma    = exp(-tSigma/2)
    z[1..T-1]: z_1 = z1,  z_t   = z_{t-1}  + sigma * zinn_{t-1}
    x[1..T]  : x_1 = x1,  x_t   = x_{t-1}  + sigma * xinn_{t-1}
    tau[1..T]: tau_1=tau1, tau_t = tau_{t-1} + exp(z_{t-1}/2) * tauinn_{t-1}
    target  += 5*tSigma - exp(tSigma)/2
             + sum N(zinn|0,1) + sum N(xinn|0,1) + sum N(tauinn|0,1)
             + sum N(y_t | tau_t, exp(x_t/2))

``proper=False`` is the reference model verbatim, whose posterior is
improper: ``sw_innov.stan:40-42`` comments out the initial-state
priors, and the density is exactly flat as ``z1 -> -inf``.
``proper=True`` restores the three N(0, 1) priors on ``z1``, ``x1`` and
``tau1``.

The gradient is analytic and batched.  With ``r = y - tau``,
``a_t = r_t^2 e^{-x_t}/2 - 1/2``, ``b_t = r_t e^{-x_t}`` and ``A``,
``B``, ``C`` the suffix sums (``A_k = sum_{t >= k} a_t``, 0-based)::

    d/dx1       = A_0,   d/dxinn_k   = -xinn_k + sigma A_{k+1}
    d/dtau1     = B_0,   d/dtauinn_k = -tauinn_k + e^{z_k/2} B_{k+1}
    c_k         = e^{z_k/2} tauinn_k B_{k+1} / 2
    d/dz1       = C_0,   d/dzinn_j   = -zinn_j + sigma C_{j+1}
    d/dtSigma   = 5 - e^{tSigma}/2
                  - sigma/2 (sum_j zinn_j C_{j+1} + sum_k xinn_k A_{k+1})

minus ``z1``, ``x1``, ``tau1`` under ``proper``.  It is the plain
version of the gradient the CUDA round kernel fuses into its leapfrog
step (``kernel_id="stock_watson"``, with ``T``, ``proper`` and ``y`` in
``kernel_args``; ``y(like)`` is the series on ``like``'s device in its
dtype), and of its summary ``[sigma, z, x, tau]``.
"""

import json
import math
from pathlib import Path

import numpy as np
import torch

from .base import Target, constant_like

_LOG_2PI = math.log(2.0 * math.pi)
_DATA_PATH = (Path(__file__).resolve().parents[2] / "examples" / "data"
              / "swdata.json")


def load_sw_data(path=None):
    """``(T, y)``: the series length and the float64 series."""
    with open(path or _DATA_PATH) as f:
        d = json.load(f)
    return int(d["T"]), np.asarray(d["y"], dtype=np.float64)


def _split(q, T):
    return (q[..., 0], q[..., 1], q[..., 2:T], q[..., T], q[..., T + 1:2 * T],
            q[..., 2 * T], q[..., 2 * T + 1:3 * T])


def _prepend_zero(x):
    return torch.cat([torch.zeros_like(x[..., :1]), x], dim=-1)


def _suffix_sum(x):
    """``out[..., k] = sum_{t >= k} x[..., t]``."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1), (-1,))


def _states(q, T):
    t_sigma, z1, zinn, x1, xinn, tau1, tauinn = _split(q, T)
    sigma = torch.exp(-0.5 * t_sigma)
    z = z1[..., None] + _prepend_zero(sigma[..., None]
                                      * torch.cumsum(zinn, dim=-1))
    x = x1[..., None] + _prepend_zero(sigma[..., None]
                                      * torch.cumsum(xinn, dim=-1))
    tau = tau1[..., None] + _prepend_zero(
        torch.cumsum(torch.exp(0.5 * z) * tauinn, dim=-1))
    return t_sigma, sigma, z, x, tau, (zinn, xinn, tauinn)


def stock_watson(data_path=None, proper=False) -> Target:
    """The Stock-Watson target over the series at ``data_path`` (the
    repo's ``examples/data/swdata.json`` by default)."""
    T, y_np = load_sw_data(data_path)
    y64 = torch.from_numpy(y_np)
    dim = 3 * T
    n_inn = (T - 2) + 2 * (T - 1)
    y_like = constant_like(y64)  # the series on q's device, in its dtype

    def lp_of(q, t_sigma, z, x, tau, inn):
        zinn, xinn, tauinn = inn
        lp = 5.0 * t_sigma - 0.5 * torch.exp(t_sigma)
        if proper:
            z1, x1, tau1 = q[..., 1], q[..., T], q[..., 2 * T]
            lp = lp - 0.5 * (z1 * z1 + x1 * x1 + tau1 * tau1 + 3.0 * _LOG_2PI)
        lp = lp - 0.5 * (torch.sum(zinn * zinn, dim=-1)
                         + torch.sum(xinn * xinn, dim=-1)
                         + torch.sum(tauinn * tauinn, dim=-1)
                         ) - 0.5 * n_inn * _LOG_2PI
        resid = y_like(q) - tau
        lp = lp - 0.5 * torch.sum(resid * resid * torch.exp(-x) + x, dim=-1)
        return lp - 0.5 * T * _LOG_2PI

    def logp_batched(q):
        t_sigma, _, z, x, tau, inn = _states(q, T)
        return lp_of(q, t_sigma, z, x, tau, inn)

    def logp(q):
        return logp_batched(q[None, :])[0]

    def logp_grad(q):
        t_sigma, sigma, z, x, tau, inn = _states(q, T)
        zinn, xinn, tauinn = inn
        lp = lp_of(q, t_sigma, z, x, tau, inn)
        r = y_like(q) - tau
        ex = torch.exp(-x)
        a = _suffix_sum(0.5 * r * r * ex - 0.5)        # A_k, [..., T]
        b = _suffix_sum(r * ex)                        # B_k, [..., T]
        ez = torch.exp(0.5 * z)                        # [..., T-1]
        c = _suffix_sum(0.5 * ez * tauinn * b[..., 1:])  # C_k, [..., T-1]
        sg = sigma[..., None]
        g_ts = 5.0 - 0.5 * torch.exp(t_sigma) - 0.5 * sigma * (
            torch.sum(zinn * c[..., 1:], dim=-1)
            + torch.sum(xinn * a[..., 1:], dim=-1))
        g_z1, g_x1, g_tau1 = c[..., 0], a[..., 0], b[..., 0]
        if proper:
            g_z1 = g_z1 - q[..., 1]
            g_x1 = g_x1 - q[..., T]
            g_tau1 = g_tau1 - q[..., 2 * T]
        grad = torch.cat([
            g_ts[..., None], g_z1[..., None], -zinn + sg * c[..., 1:],
            g_x1[..., None], -xinn + sg * a[..., 1:],
            g_tau1[..., None], -tauinn + ez * b[..., 1:]], dim=-1)
        return lp, grad

    def generated(q):
        """The constrained quantities ``concat([sigma, z, x, tau])``
        (dg = 3T)."""
        _, sigma, z, x, tau, _ = _states(q, T)
        return torch.cat([sigma[..., None], z, x, tau], dim=-1)

    generated.kernel_summary = "stock_watson"
    suffix = "_proper" if proper else ""
    return Target(logp, dim, name=f"stock_watson_T{T}{suffix}",
                  generated=generated, logp_grad=logp_grad,
                  kernel_id="stock_watson",
                  kernel_args=dict(T=T, proper=bool(proper), y=y_like))
