"""The P-squared quantile estimator of Jain and Chlamtac (1985), one per
chain, in plain torch.

Each estimator keeps five marker heights ``q``, their integer positions
``n`` (1-based) and a buffer ``x`` of its first five values.  The first
five values are buffered; at the fifth they are sorted into the
markers.  From the sixth on, a value beyond an end marker replaces it,
the markers above the value's cell move up one position, and each
interior marker whose position lies a whole step or more from its
desired one (and from its neighbour) moves one step toward it, its
height by the parabolic formula, or linearly where that would leave the
neighbours' interval.  The interior markers move in order, each reading
its lower neighbour as already moved.  The middle marker is the
estimate.
"""

import torch


def init(prob, C, dtype, device):
    return dict(npush=torch.zeros(C, dtype=torch.int32, device=device),
                x=torch.zeros((C, 5), dtype=dtype, device=device),
                q=torch.zeros((C, 5), dtype=dtype, device=device),
                n=torch.arange(1, 6, dtype=torch.int32, device=device)
                .repeat(C, 1),
                p=torch.tensor(float(prob), dtype=dtype, device=device))


def estimate(e):
    return e["q"][:, 2]


def push(e, value, mask):
    """Push ``value [C]`` into the chains' estimators where ``mask [C]``."""
    W = torch.where
    q, n, x = e["q"], e["n"], e["x"]
    dt, dev = q.dtype, q.device
    count = e["npush"] + 1
    slot = torch.arange(5, device=dev)[None]
    x_new = W(slot == (count - 1).long()[:, None], value[:, None].to(dt), x)
    first5 = count <= 5

    v = value.to(dt)
    lo, hi = v < q[:, 0], v > q[:, 4]
    cell = (v[:, None] >= q[:, 1:4]).to(torch.int32).sum(1) + 1
    cell = W(lo, 1, W(hi, 4, cell))
    qs = [q[:, i] for i in range(5)]
    qs[0] = W(lo, v, qs[0])
    qs[4] = W(hi, v, qs[4])
    ns = [n[:, i] + (i >= cell).to(torch.int32) for i in range(5)]
    cnt = count.to(dt)
    p = e["p"]
    want = [None, (cnt - 1.0) * p / 2.0 + 1.0, (cnt - 1.0) * p + 1.0,
            (cnt - 1.0) * (1.0 + p) / 2.0 + 1.0]
    for i in (1, 2, 3):
        ni, nl, nr = (ns[i].to(dt), ns[i - 1].to(dt), ns[i + 1].to(dt))
        gap = want[i] - ni
        step = ((gap >= 1.0) & (nr - ni > 1.0)) | \
            ((gap <= -1.0) & (nl - ni < -1.0))
        d = torch.sign(gap)
        para = qs[i] + d / (nr - nl) * (
            (ni - nl + d) * (qs[i + 1] - qs[i]) / (nr - ni)
            + (nr - ni - d) * (qs[i] - qs[i - 1]) / (ni - nl))
        inside = (qs[i - 1] < para) & (para < qs[i + 1])
        up = d > 0
        lin = qs[i] + d * (W(up, qs[i + 1], qs[i - 1]) - qs[i]) / (
            W(up, nr, nl) - ni)
        qs[i] = W(step, W(inside, para, lin), qs[i])
        ns[i] = W(step, ns[i] + d.to(torch.int32), ns[i])
    q_new = torch.stack(qs, 1)
    n_new = torch.stack(ns, 1)
    at5 = (count == 5)[:, None]
    q_new = W(first5[:, None], W(at5, torch.sort(x_new, 1).values, q), q_new)
    n_new = W(first5[:, None], n, n_new)
    m = mask[:, None]
    return dict(npush=W(mask, count, e["npush"]), x=W(m, x_new, x),
                q=W(m, q_new, q), n=W(m, n_new, n), p=p)
