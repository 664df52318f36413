"""Target-density protocol (``walnuts_tpu/targets/base.py``).

A target is a scalar log density over a ``[D]`` position.  Every entry
point is batched over chains: ``logp_grad`` takes ``[..., D]``.  The
gradient is an analytic batched override where one is given, and
otherwise autograd of the sum of the batch's log densities (one
backward pass for the whole batch, as the JAX version's ``vjp``).

``kernel_id`` names a target that the CUDA round kernel implements
with its gradient fused into the leapfrog step (``"funnel"``,
``"std_gauss"``, ``"stock_watson"``); ``kernel_param`` is the funnel's
one parameter (its ``scale``) and ``kernel_args`` holds the parameters
of a target that has more (Stock-Watson's series length ``T``, its
``proper`` flag and the series ``y``).  A target without a
``kernel_id`` runs through the same kernel on the card, in its
external-gradient instantiation: the host calls ``logp_grad`` on every
chain's position at each gradient point, between two launches
(``sampler/round_kernel.py``).
"""

from typing import Callable, Optional

import torch


class Target:
    """A differentiable target distribution.

    Args:
        logp: scalar log density taking a single ``[D]`` position.
        dim: dimensionality of the unconstrained parameter vector.
        name: display name.
        generated: optional batched ``[..., D] -> [..., dg]`` transform
            applied to positions before storing samples.
        logp_grad: optional analytic batched ``[..., D] ->
            (lp[...], grad[..., D])`` override.
        kernel_id: name of the CUDA round kernel's fused target, if any.
        kernel_param: the fused funnel's scale.
        kernel_args: the parameters of a fused target with more than one.
    """

    def __init__(
        self,
        logp: Callable,
        dim: int,
        name: str = "target",
        generated: Optional[Callable] = None,
        logp_grad: Optional[Callable] = None,
        kernel_id: Optional[str] = None,
        kernel_param: float = 0.0,
        kernel_args: Optional[dict] = None,
    ):
        self._logp = logp
        self.dim = int(dim)
        self.name = name
        self._generated = generated
        self._logp_grad = logp_grad
        self.kernel_id = kernel_id
        self.kernel_param = float(kernel_param)
        self.kernel_args = dict(kernel_args or {})

    def logp(self, q):
        """Batched log density: ``[..., D] -> [...]``."""
        if q.ndim == 1:
            return self._logp(q)
        flat = q.reshape(-1, q.shape[-1])
        return torch.func.vmap(self._logp)(flat).reshape(q.shape[:-1])

    def logp_grad(self, q):
        """Batched value-and-gradient: ``[..., D] -> ([...], [..., D])``."""
        if self._logp_grad is not None:
            return self._logp_grad(q)
        with torch.enable_grad():
            qg = q.detach().requires_grad_(True)
            lp = self.logp(qg)
            (grad,) = torch.autograd.grad(lp.sum(), qg)
        return lp.detach(), grad

    def grad(self, q):
        return self.logp_grad(q)[1]

    def hvp(self, q, v):
        """Hessian-vector product, forward over reverse (``torch.func``):
        the forward derivative of the analytic gradient where there is
        one, else of the functional gradient of the batch's summed log
        density (``logp_grad``'s autograd path cannot run inside a
        ``torch.func`` transform)."""
        if self._logp_grad is not None:
            grad = lambda x: self._logp_grad(x)[1]  # noqa: E731
        else:
            grad = torch.func.grad(lambda x: self.logp(x).sum())
        return torch.func.jvp(grad, (q,), (v,))[1]

    def hessian(self, q):
        return torch.func.hessian(self._logp)(q)

    def hessian_batched(self, q):
        """Batched Hessians ``[..., D] -> [..., D, D]`` (the implicit
        midpoint integrator's Newton mode)."""
        if q.ndim == 1:
            return self.hessian(q)
        flat = q.reshape(-1, q.shape[-1])
        out = torch.func.vmap(torch.func.hessian(self._logp))(flat)
        return out.reshape(q.shape[:-1] + out.shape[-2:])

    def generated(self, q):
        if self._generated is None:
            return q
        return self._generated(q)

    @property
    def generated_dim(self):
        if self._generated is None:
            return self.dim
        return int(self._generated(torch.zeros(1, self.dim)).shape[-1])

    def __repr__(self):
        return f"Target({self.name}, dim={self.dim})"
