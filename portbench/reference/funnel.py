"""Neal's funnel in D dimensions: ``omega = q[0] ~ N(0, scale^2)`` and
``q[i] | omega ~ N(0, e^omega)`` for ``i = 1..D-1``."""

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class Funnel:
    def __init__(self, dim, scale=3.0):
        self.dim = int(dim)
        self.scale = float(scale)

    def logp_grad(self, q):
        """``(log density [C], gradient [C, D])`` of ``q [C, D]``."""
        k = self.dim - 1
        w, x = q[..., 0], q[..., 1:]
        ss = torch.sum(x * x, dim=-1)
        e = torch.exp(-w)
        z = w / self.scale
        lp = (-0.5 * (z * z) - math.log(self.scale) - 0.5 * _LOG_2PI
              - 0.5 * e * ss - 0.5 * k * w - 0.5 * k * _LOG_2PI)
        gw = -w / self.scale ** 2 + 0.5 * e * ss - 0.5 * k
        return lp, torch.cat([gw[..., None], -x * e[..., None]], dim=-1)

    @staticmethod
    def omega_sumsq(q):
        """The summary ``(omega, sum of x^2)`` of positions ``[..., D]``."""
        return torch.stack([q[..., 0], torch.sum(q[..., 1:] ** 2, dim=-1)],
                           dim=-1)

    def identity(self, q):
        return q

    def exact(self, gen, C, dtype, device):
        """``C`` independent draws from the funnel, from ``gen``."""
        z = torch.randn((C, self.dim), generator=gen, device=device,
                        dtype=torch.float32)
        w = self.scale * z[:, :1]
        return torch.cat([w, torch.exp(0.5 * w) * z[:, 1:]], dim=1).to(dtype)


def build(args, root):
    return Funnel(**args)
