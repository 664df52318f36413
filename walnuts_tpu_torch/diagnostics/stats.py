"""Validation statistics of the reference's analysis utilities
(``walnuts_tpu/diagnostics/stats.py``, after ``WALNUTSpy/MCMCutils.py:15-40``)
as functions that return the arrays the reference would plot."""

import torch


def qq_normal(samples):
    """Theoretical-vs-sample normal quantiles: ``(theoretical, sorted
    samples)``, the theoretical quantiles taken at the plotting positions
    ``(i + 0.5) / n`` and scaled by the sample mean and sd."""
    x = torch.sort(samples.reshape(-1)).values
    n = x.shape[0]
    probs = (torch.arange(n, device=x.device).to(x.dtype) + 0.5) / n
    theo = (torch.special.ndtri(probs) * torch.std(x, correction=0)
            + torch.mean(x))
    return theo, x


def index_stat_histogram(diagnostics, bins: int = 20):
    """Histogram of ``|diagnostics[..., 23]|``, the normalised signed
    time position of the selected state, over ``(0, 1]``: near-uniform
    for a correct sampler.

    Returns ``(counts, edges, chi2)``; ``counts`` are floats, as JAX's
    ``histogram`` gives them, and ``chi2`` is the uniformity chi-square
    against the flat expectation.  A value on an edge goes to the bin on
    its right, 1.0 to the last."""
    x = torch.abs(diagnostics[..., 23].reshape(-1))
    x = x[x > 0]
    edges = torch.linspace(0.0, 1.0, bins + 1, dtype=x.dtype,
                           device=x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=x.dtype, device=x.device)
    counts = counts.index_add(0, idx, torch.ones_like(x))[1:bins + 1]
    expect = x.shape[0] / bins
    chi2 = torch.sum((counts - expect) ** 2 / expect)
    return counts, edges, chi2
