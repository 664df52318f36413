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

Inside a dim split (:func:`..parallel.mesh.dim_split`) positions are a
rank's columns ``d0 .. d1-1``.  A separable target gives
``block_logp_grad(q, split)``, which sums over its own columns and
all-reduces the partial sums over the dim group; every other target
takes one general route: the columns are gathered over the group, the
whole ``logp_grad`` runs on each rank, and each keeps its columns of the
gradient.  ``generated`` keeps the rank's columns when it is the
identity, and otherwise runs on the gathered rows, so that the ranks of
a group hold the same rows of generated quantities.
"""

from typing import Callable, Optional

import torch

from ..parallel.mesh import current_dim_split, dim_gather, dim_split


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
        block_logp_grad: optional ``(q_block, split) -> (lp[...],
            grad_block)`` of a separable target under a dim split
            (``split`` a :class:`..parallel.mesh.DimSplit`).
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
        block_logp_grad: Optional[Callable] = None,
    ):
        self._logp = logp
        self.dim = int(dim)
        self.name = name
        self._generated = generated
        self._logp_grad = logp_grad
        self.kernel_id = kernel_id
        self.kernel_param = float(kernel_param)
        self.kernel_args = dict(kernel_args or {})
        self._block_logp_grad = block_logp_grad

    def logp(self, q):
        """Batched log density: ``[..., D] -> [...]``."""
        if q.ndim == 1:
            return self._logp(q)
        flat = q.reshape(-1, q.shape[-1])
        return torch.func.vmap(self._logp)(flat).reshape(q.shape[:-1])

    def logp_grad(self, q):
        """Batched value-and-gradient: ``[..., D] -> ([...], [..., D])``;
        under a dim split, of this rank's columns (the log density whole,
        the gradient's columns)."""
        split = current_dim_split()
        if split is None:
            return self._whole_logp_grad(q)
        if self._block_logp_grad is not None:
            return self._block_logp_grad(q, split)
        q = dim_gather(q)
        with dim_split(None, q.shape[-1]):   # whole rows from here on
            lp, g = self._whole_logp_grad(q)
        return lp, g[..., split.d0:split.d1]

    def _whole_logp_grad(self, q):
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
        q = dim_gather(q)
        with dim_split(None, q.shape[-1]):
            return self._generated(q)

    @property
    def generated_dim(self):
        if self._generated is None:
            return self.dim
        return int(self._generated(torch.zeros(1, self.dim)).shape[-1])

    def __repr__(self):
        return f"Target({self.name}, dim={self.dim})"


def constant_like(t64):
    """``like(q)``: the constant tensor ``t64`` on ``q``'s device in
    ``q``'s dtype, made once per device and dtype, so that a gradient
    call copies nothing from the host (and can be captured in a CUDA
    graph)."""
    cache = {}

    def like(q):
        key = (q.device, q.dtype)
        if key not in cache:
            cache[key] = t64.to(device=q.device, dtype=q.dtype)
        return cache[key]

    return like
