"""Batched P-squared online quantile estimator (``walnuts_tpu/utils/p2.py``).

Jain & Chlamtac (1985) as a fixed-shape, masked tensor state machine:
one estimator per batch element, five marker heights ``q``, five marker
positions ``n`` and the first-five-sample buffer ``x``.  Pushes with
``mask=False`` are no-ops.  The arithmetic follows the JAX version
operation for operation, so the two agree to rounding.
"""

from typing import NamedTuple

import torch


class P2State(NamedTuple):
    npush: torch.Tensor  # [...] int32, number of samples pushed
    x: torch.Tensor      # [..., 5] first-five-sample buffer
    q: torch.Tensor      # [..., 5] marker heights
    n: torch.Tensor      # [..., 5] int32 marker positions (1-based)
    p: torch.Tensor      # [...] probe probability


def p2_init(prob, batch_shape=(), dtype=torch.float32, device=None):
    batch_shape = tuple(batch_shape)
    return P2State(
        npush=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        x=torch.zeros(batch_shape + (5,), dtype=dtype, device=device),
        q=torch.zeros(batch_shape + (5,), dtype=dtype, device=device),
        n=torch.arange(1, 6, dtype=torch.int32, device=device).expand(
            batch_shape + (5,)).clone(),
        p=torch.full(batch_shape, prob, dtype=dtype, device=device),
    )


def p2_quantile(state: P2State):
    """Current estimate: the middle marker height."""
    return state.q[..., 2]


def _push(state: P2State, xi):
    npush = state.npush + 1
    dtype = state.q.dtype
    xi = torch.as_tensor(xi, dtype=dtype, device=state.q.device)
    xi = xi.expand(npush.shape)
    idx5 = torch.arange(5, dtype=torch.int32, device=state.q.device)

    # warm-up phase: buffer the first five samples, then sort
    x = torch.where(idx5 == (npush - 1)[..., None], xi[..., None], state.x)
    q_sorted = torch.sort(x, dim=-1).values
    in_warmup = npush <= 5
    at_five = npush == 5

    # steady state: classify xi into a marker interval
    q = state.q.clone()
    n = state.n
    below = xi < q[..., 0]
    above = xi > q[..., 4]
    k_mid = 1 + (xi[..., None] >= q[..., 1:4]).to(torch.int32).sum(-1)
    k = torch.where(below, 0, torch.where(above, 5, k_mid))

    # extreme samples replace the end markers
    q[..., 0] = torch.where(below, xi, q[..., 0])
    q[..., 4] = torch.where(above, xi, q[..., 4])
    k = torch.clamp(k, 1, 4)

    # shift marker positions at and above interval k
    n = n + (idx5 >= k[..., None]).to(torch.int32)

    # desired (fractional) positions
    nn = npush.to(dtype)
    pp = state.p
    npp = torch.stack([
        torch.ones_like(nn),
        0.5 * (nn - 1.0) * pp + 1.0,
        (nn - 1.0) * pp + 1.0,
        (nn - 1.0) * (1.0 + pp) / 2.0 + 1.0,
        nn,
    ], dim=-1)

    # parabolic / linear adjustment of the interior markers, in order
    # (marker i reads marker i-1 as already adjusted)
    for i in range(1, 4):
        ni = n[..., i].to(dtype)
        nip = n[..., i + 1].to(dtype)
        nim = n[..., i - 1].to(dtype)
        di = npp[..., i] - ni
        move = (((di >= 1.0) & (nip - ni > 1.0))
                | ((di <= -1.0) & (nim - ni < -1.0)))
        d = torch.sign(di)
        qi = q[..., i]
        q_para = qi + (d / (nip - nim)) * (
            (ni - nim + d) * (q[..., i + 1] - qi) / (nip - ni)
            + (nip - ni - d) * (qi - q[..., i - 1]) / (ni - nim))
        ok = (q[..., i - 1] < q_para) & (q_para < q[..., i + 1])
        d_int = d.to(torch.int32)
        q_nb = torch.where(d_int > 0, q[..., i + 1], q[..., i - 1])
        n_nb = torch.where(d_int > 0, n[..., i + 1], n[..., i - 1]).to(dtype)
        q_lin = qi + d * (q_nb - qi) / (n_nb - ni)
        q_new = torch.where(ok, q_para, q_lin)
        q[..., i] = torch.where(move, q_new, qi)
        n = n.clone()
        n[..., i] = torch.where(move, n[..., i] + d_int, n[..., i])

    q_out = torch.where(in_warmup[..., None],
                        torch.where(at_five[..., None], q_sorted, state.q), q)
    n_out = torch.where(in_warmup[..., None], state.n, n)
    return P2State(npush=npush, x=x, q=q_out, n=n_out, p=state.p)


def p2_push(state: P2State, xi, mask=None):
    """Push one sample per batch element; ``mask=False`` elements are
    no-ops."""
    new = _push(state, xi)
    if mask is None:
        return new
    m1 = mask[..., None]
    return P2State(
        npush=torch.where(mask, new.npush, state.npush),
        x=torch.where(m1, new.x, state.x),
        q=torch.where(m1, new.q, state.q),
        n=torch.where(m1, new.n, state.n),
        p=state.p,
    )
