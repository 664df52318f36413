"""The pooled warmup's consensus, worked out again from the per-chain
P-squared estimators (Jain and Chlamtac 1985): the batch median, over
the chains whose estimator has taken more than 10 values, of each
chain's middle marker height.  While any chain is still in warmup,
``delta = target / median(q_delta)`` and ``H = delta^(1/3) *
exp(median(q_h))``; a median over no chain is NaN and changes
nothing."""

import torch


def nanmedian(x):
    """numpy's ``nanmedian`` of a 1-D tensor: the mean of the two middle
    values for an even count, NaN for none."""
    v = x[~torch.isnan(x)]
    if v.numel() == 0:
        return torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
    v = torch.sort(v).values
    n = v.numel()
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def consensus(it, npush_h, q_h, npush_d, q_d, warmup_iter, delta_target,
              h_prev, delta_prev):
    """``(H, delta)`` after a period: ``q_h``/``q_d`` are the estimators'
    middle markers ``[C]``, ``npush_*`` their counts ``[C]``, ``it`` the
    chains' completed transitions."""
    nan = float("nan")
    in_wu = bool(torch.min(it) < warmup_iter)
    med_d = nanmedian(torch.where(npush_d > 10, q_d, nan))
    delta = delta_prev
    if in_wu and bool(torch.isfinite(med_d)) and float(med_d) > 0:
        delta = delta_target / med_d
    med_h = nanmedian(torch.where(npush_h > 10, q_h, nan))
    h = h_prev
    if in_wu and bool(torch.isfinite(med_h)):
        h = delta ** (1.0 / 3.0) * torch.exp(med_h)
    return h, delta
