"""Effective sample size and Rhat, batched over chains and parameters
(``walnuts_tpu/diagnostics/ess.py``).

Multi-chain bulk ESS: FFT autocovariance, Geyer initial-monotone
positive-sequence truncation, cross-chain variance pooling; ESS per
1000 gradient evaluations; and split-Rhat after Vehtari et al. (2021).
"""

import torch

from ..parallel.mesh import gather_rows


def _autocov(x):
    """Per-chain biased autocovariance of time-major ``[N, C]`` draws."""
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    m = 1 << (2 * n - 1).bit_length()  # pad >= 2n for linear correlation
    f = torch.fft.rfft(xc, n=m, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=0)[:n]
    return acov / n


def ess(draws):
    """Multi-chain bulk ESS of ``[N, C]`` (scalar) or ``[N, C, K]``
    (``[K]``) draws."""
    if draws.ndim == 2:
        return _ess_nc(draws)
    return torch.stack([_ess_nc(draws[..., k]) for k in range(draws.shape[2])])


def _ess_nc(x):
    n, c = x.shape
    acov = _autocov(x)                        # [N, C]
    chain_mean = torch.mean(x, dim=0)         # [C]
    mean_var = torch.mean(acov[0]) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + torch.var(chain_mean, correction=1)

    rho = 1.0 - (mean_var - torch.mean(acov, dim=1)) / var_plus  # [N]

    # Geyer pairing: P_k = rho_{2k} + rho_{2k+1}; truncate at the first
    # negative pair and enforce a monotone decrease
    n_pairs = n // 2
    p = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    keep = torch.cumprod((p > 0).to(x.dtype), dim=0) > 0
    p = torch.where(keep, p, 0.0)
    p = torch.cummin(p, dim=0).values
    p = torch.clamp(p, min=0.0)
    tau = -1.0 + 2.0 * torch.sum(p)
    floor = 1.0 / torch.log10(torch.tensor(float(n * c), dtype=x.dtype,
                                           device=x.device))
    tau = torch.maximum(tau, floor)
    return n * c / tau


def ess_per_grad(draws, n_grad_evals):
    """ESS per 1000 gradient evaluations, the reference's efficiency
    metric (``mainGaussESS.py:50-55``)."""
    return 1000.0 * ess(draws) / n_grad_evals


def rhat(draws):
    """Classic (non-split) potential scale reduction over ``[N, C]`` or
    ``[N, C, K]`` draws."""
    if draws.ndim == 2:
        return _rhat_nc(draws)
    return torch.stack([_rhat_nc(draws[..., k])
                        for k in range(draws.shape[2])])


def _rhat_nc(x):
    n = x.shape[0]
    chain_mean = torch.mean(x, dim=0)
    chain_var = torch.var(x, dim=0, correction=1)
    w = torch.mean(chain_var)
    b = n * torch.var(chain_mean, correction=1)
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / w)


def split_rhat(draws):
    """Split-Rhat: halve each chain before computing Rhat."""
    n = draws.shape[0] // 2
    split = torch.cat([draws[:n], draws[n:2 * n]], dim=1)
    return rhat(split)


def gather_chains(draws, mesh):
    """All-gather a rank's ``[N, C_local, ...]`` draws along the chain
    axis in rank order: every rank gets the whole ``[N, C, ...]`` batch,
    so :func:`ess`, :func:`rhat` and :func:`split_rhat` of the result
    equal the single-process values (``draws`` itself without a mesh
    that splits the chains)."""
    return gather_rows(draws, mesh, dim=1)
