"""Stock and Watson's stochastic-volatility model of inflation, as the
reference's ``sw_innov.stan`` states it, with the proper N(0, 1) priors
on the three initial states when ``proper``.

Parameters, in Stan's declaration order (D = 3T): ``tSigma, z1,
zinn[T-2], x1, xinn[T-1], tau1, tauinn[T-1]``.  With ``sigma =
exp(-tSigma/2)``: ``z`` and ``x`` are random walks with innovations
``sigma * zinn`` and ``sigma * xinn``, ``tau`` one with innovations
``exp(z/2) * tauinn``, and ``y_t ~ N(tau_t, exp(x_t/2))``.  The
target adds ``5 tSigma - exp(tSigma)/2`` and standard normal densities
of the innovations.  The gradient below is derived by hand from that
density (suffix sums of the residual terms run the chain rule back
through the random walks)."""

import json
import math
from pathlib import Path

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _suffix(x):
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1), (-1,))


def _walk(first, steps):
    """``[first, first + cumsum(steps)]`` along the last axis."""
    return torch.cat([first[..., None],
                      first[..., None] + torch.cumsum(steps, dim=-1)], dim=-1)


class StockWatson:
    def __init__(self, data_path, proper, root=None):
        path = Path(data_path)
        if not path.is_absolute() and root is not None:
            path = Path(root) / path
        d = json.loads(path.read_text())
        self.T = int(d["T"])
        self.y64 = torch.tensor(d["y"], dtype=torch.float64)
        self.proper = bool(proper)
        self.dim = 3 * self.T
        self._y = {}

    def y(self, like):
        key = (like.device, like.dtype)
        if key not in self._y:
            self._y[key] = self.y64.to(like.device, like.dtype)
        return self._y[key]

    def _parts(self, q):
        T = self.T
        ts, z1, zinn = q[..., 0], q[..., 1], q[..., 2:T]
        x1, xinn = q[..., T], q[..., T + 1:2 * T]
        tau1, tauinn = q[..., 2 * T], q[..., 2 * T + 1:3 * T]
        sigma = torch.exp(-0.5 * ts)
        z = _walk(z1, sigma[..., None] * zinn)            # [.., T-1]
        x = _walk(x1, sigma[..., None] * xinn)            # [.., T]
        tau = _walk(tau1, torch.exp(0.5 * z) * tauinn)    # [.., T]
        return ts, sigma, zinn, xinn, tauinn, z, x, tau

    def logp_grad(self, q):
        T = self.T
        ts, sigma, zinn, xinn, tauinn, z, x, tau = self._parts(q)
        r = self.y(q) - tau
        ex = torch.exp(-x)
        n_inn = 3 * T - 4
        lp = (5.0 * ts - 0.5 * torch.exp(ts)
              - 0.5 * (torch.sum(zinn * zinn, dim=-1)
                       + torch.sum(xinn * xinn, dim=-1)
                       + torch.sum(tauinn * tauinn, dim=-1))
              - 0.5 * n_inn * _LOG_2PI
              - 0.5 * torch.sum(r * r * ex + x, dim=-1) - 0.5 * T * _LOG_2PI)
        if self.proper:
            z1, x1, tau1 = q[..., 1], q[..., T], q[..., 2 * T]
            lp = lp - 0.5 * (z1 * z1 + x1 * x1 + tau1 * tau1
                             + 3.0 * _LOG_2PI)
        # d lp / d x_t = a_t, d lp / d tau_t = b_t; their suffix sums give
        # the gradient of every innovation that feeds x_t or tau_t
        A = _suffix(0.5 * r * r * ex - 0.5)
        B = _suffix(r * ex)
        ez = torch.exp(0.5 * z)
        Cs = _suffix(0.5 * ez * tauinn * B[..., 1:])
        sg = sigma[..., None]
        g_ts = 5.0 - 0.5 * torch.exp(ts) - 0.5 * sigma * (
            torch.sum(zinn * Cs[..., 1:], dim=-1)
            + torch.sum(xinn * A[..., 1:], dim=-1))
        g_z1, g_x1, g_tau1 = Cs[..., 0], A[..., 0], B[..., 0]
        if self.proper:
            g_z1 = g_z1 - q[..., 1]
            g_x1 = g_x1 - q[..., T]
            g_tau1 = g_tau1 - q[..., 2 * T]
        g = torch.cat([g_ts[..., None], g_z1[..., None],
                       -zinn + sg * Cs[..., 1:], g_x1[..., None],
                       -xinn + sg * A[..., 1:], g_tau1[..., None],
                       -tauinn + ez * B[..., 1:]], dim=-1)
        return lp, g

    def constrained(self, q):
        """The summary ``[sigma, z (T-1), x (T), tau (T)]`` (width 3T)."""
        _, sigma, _, _, _, z, x, tau = self._parts(q)
        return torch.cat([sigma[..., None], z, x, tau], dim=-1)

    def identity(self, q):
        return q


def build(args, root):
    return StockWatson(root=root, **args)
