"""Chain driver and warmup adaptation of the scan engine
(``walnuts_tpu/sampler/driver.py``).

Per iteration: a full momentum refresh and one WALNUTS transition, then
the masked warmup adaptation of the JAX version (``WALNUTS.py:701-712``):

* ``delta``: record ``orbitEnergyError / delta`` each warmup iteration
  and, after iteration 10, set ``delta = target / quantile_q(history)``;
* ``H``: every computed macro step pushes ``log(igrConst)`` into a P2
  estimator, and ``H = delta^{1/3} * exp(quantile)``.

Each chain runs its own adaptation, or with ``pooled=True`` every chain
takes the batch median of the statistics.  With the chains split over
the ranks of a mesh (``mesh=``), each rank draws its own rows of the
whole batch's draws and the median is taken over the statistics of
every rank, all-gathered in rank order, so rank r's results are its
rows of the single-process run.  JAX's ``lax.scan`` becomes a
Python loop.  The iteration counter ``iter_n`` is a host int, so the
warmup test costs no device sync; a checkpoint stores it as an int32
array, as JAX's does.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.mesh import chain_block, gather_rows, split
from ..utils import threefry
from ..utils.device import DEFAULT_DEVICE, resolve_device, to_device
from ..utils.p2 import P2State, p2_init, p2_quantile
from .transition import WalnutsConfig, walnuts_transition


class WarmupConfig(NamedTuple):
    """Static warmup configuration (defaults of ``WALNUTS.py:115-127``).

    ``pooled=True`` replaces each chain's tuning by the batch median of
    the per-chain adaptation statistics, so every chain shares one
    ``(H, delta)``.
    """

    warmup_iter: int = 1000
    adapt_h: bool = True
    adapt_h_target: float = 0.8
    adapt_delta: bool = True
    adapt_delta_target: float = 0.6
    adapt_delta_quantile: float = 0.9
    pooled: bool = False


class SamplerState(NamedTuple):
    q: torch.Tensor         # [C, D]
    lp: torch.Tensor        # [C]
    g: torch.Tensor         # [C, D]
    h: torch.Tensor         # [C] macro step size
    delta: torch.Tensor     # [C] tolerance
    p2: P2State             # per-chain log-igrConst quantile estimator
    err_facs: torch.Tensor  # [C, warmup_iter] energy-error inflation history
    iter_n: int             # completed iterations (host int)


def masked_quantile(x, n, prob):
    """``np.quantile(x[:, :n], prob)`` per row: unfilled columns are
    pushed to +inf before an ascending sort, then the linear-interpolation
    quantile is read at position ``(n - 1) * prob``, in ``x``'s dtype,
    with the JAX version's clip bounds."""
    C, W = x.shape
    n = int(n)
    npdt = np.float32 if x.dtype == torch.float32 else np.float64
    cols = torch.arange(W, device=x.device)
    xs = torch.sort(torch.where(cols[None, :] < n, x, torch.inf),
                    dim=-1).values
    pos = (npdt(n) - npdt(1.0)) * npdt(prob)
    lo = min(max(int(np.floor(pos)), 0), W - 1)
    hi = min(max(lo + 1, 0), max(n - 1, 0))
    frac = float(pos - npdt(lo))
    vlo, vhi = xs[:, lo], xs[:, hi]
    return vlo + frac * (vhi - vlo)


def _median(x):
    """``jnp.median``: the mean of the two middle values for an even
    count, NaN if any value is NaN; no host sync."""
    n = x.numel()
    xs = torch.sort(x).values
    mid = (xs[(n - 1) // 2] + xs[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.nan, mid)


def init_state(target, q0, h0=0.2, delta0=0.05,
               warmup: WarmupConfig = WarmupConfig()) -> SamplerState:
    C = q0.shape[0]
    dtype, dev = q0.dtype, q0.device
    lp, g = target.logp_grad(q0)
    return SamplerState(
        q=q0, lp=lp, g=g,
        h=torch.full((C,), h0, dtype=dtype, device=dev),
        delta=torch.full((C,), delta0, dtype=dtype, device=dev),
        p2=p2_init(1.0 - warmup.adapt_h_target, (C,), dtype, dev),
        err_facs=torch.zeros((C, max(warmup.warmup_iter, 1)), dtype=dtype,
                             device=dev),
        iter_n=0,
    )


def sampler_step(key, state: SamplerState, *, target, cfg: WalnutsConfig,
                 warmup: WarmupConfig, inv_mass=None, mesh=None):
    """One MCMC iteration plus the masked warmup adaptation; ``mesh`` as
    in :func:`run_walnuts`."""
    it = state.iter_n + 1  # 1-based, like the reference loop
    in_warmup = it <= warmup.warmup_iter
    block = chain_block(mesh, state.q.shape[0]) if split(mesh) else None

    def median(x):  # the batch median, over every rank's chains
        return _median(gather_rows(x, mesh))

    res = walnuts_transition(
        key, state.q, state.lp, state.g, state.h, state.delta, state.p2,
        in_warmup and warmup.adapt_h,
        target=target, cfg=cfg, inv_mass=inv_mass, chain_block=block)

    delta = state.delta
    err_facs = state.err_facs
    if warmup.adapt_delta and in_warmup:
        fac = res.diagnostics[:, 17] / state.delta
        err_facs = err_facs.clone()
        err_facs[:, min(it - 1, err_facs.shape[1] - 1)] = fac
        if it > 10:
            quant = masked_quantile(err_facs, it,
                                    warmup.adapt_delta_quantile)
            if warmup.pooled:
                # consensus: every chain adopts the batch-median quantile
                quant = median(quant).expand(quant.shape)
            delta = warmup.adapt_delta_target / quant

    h = state.h
    if warmup.adapt_h and in_warmup:
        log_c = p2_quantile(res.p2)
        if warmup.pooled:
            log_c = median(log_c).expand(log_c.shape)
        h_new = delta ** (1.0 / 3.0) * torch.exp(log_c)
        h = torch.where(res.p2.npush > 10, h_new, h)

    new_state = SamplerState(
        q=res.q, lp=res.lp, g=res.g, h=h, delta=delta, p2=res.p2,
        err_facs=err_facs, iter_n=it)
    return new_state, res


def run_walnuts(seed, q0=None, *, target, cfg: WalnutsConfig = WalnutsConfig(),
                warmup: WarmupConfig = WarmupConfig(), num_iter: int = 2000,
                h0: float = 0.2, delta0: float = 0.05, inv_mass=None,
                collect_orbit_stats: bool = False,
                resume_state: SamplerState = None, device=DEFAULT_DEVICE,
                mesh=None):
    """Run ``num_iter`` WALNUTS iterations over a ``[C, D]`` chain batch
    (``wt.run_walnuts(jax.random.PRNGKey(seed), q0, ...)``).

    ``seed`` is an int (the key is ``PRNGKey(seed)``) or a threefry key.
    ``q0`` (a tensor or a numpy array) and ``resume_state`` are moved to
    ``device``, the card unless the caller passes ``device="cpu"``.

    Returns ``(samples, diagnostics, state)``: ``samples`` is
    ``[num_iter + 1, C, dg]`` (row 0 = the generated quantities of the
    initial positions) and ``diagnostics`` is ``[num_iter, C, 24]``;
    with ``collect_orbit_stats`` also the per-iteration orbit minima and
    maxima of the generated quantities (``[num_iter, C, 0]`` unless
    ``cfg.record_orbit_stats``, as in the JAX version).

    ``resume_state`` continues from a previous run's returned (or
    checkpointed, :mod:`..utils.checkpoint`) state: ``q0``, ``h0`` and
    ``delta0`` are ignored and the iteration counter carries on, while
    the per-iteration keys are ``fold_in(key, i)`` for ``i = 1 ..
    num_iter`` on every call, as in the JAX version.

    ``mesh`` (:func:`..parallel.make_mesh`): ``q0`` (or ``resume_state``)
    is this rank's block of chains (:func:`..parallel.shard_chains`);
    the returned samples, diagnostics and state are this rank's rows of
    the single-process run's (:func:`..diagnostics.gather_chains`
    joins them).
    """
    split(mesh)  # a mesh the engine cannot take raises before any work
    dev = resolve_device(device)
    if isinstance(seed, torch.Tensor):
        key = seed.to(device=dev, dtype=torch.int64)
    else:
        key = threefry.PRNGKey(seed, dev)
    if inv_mass is not None:
        inv_mass = torch.as_tensor(inv_mass).to(dev)
    if resume_state is not None:
        state = to_device(resume_state, dev)._replace(
            iter_n=int(resume_state.iter_n))
        q0 = state.q
    else:
        q0 = torch.as_tensor(q0).to(dev)
        state = init_state(target, q0, h0, delta0, warmup)

    gen0 = target.generated(q0)
    C = q0.shape[0]
    samples = torch.empty((num_iter + 1,) + tuple(gen0.shape),
                          dtype=gen0.dtype, device=dev)
    samples[0] = gen0
    diags = torch.empty((num_iter, C, 24), dtype=q0.dtype, device=dev)
    orbit = []
    for i in range(1, num_iter + 1):
        state, res = sampler_step(threefry.fold_in(key, i), state,
                                  target=target, cfg=cfg, warmup=warmup,
                                  inv_mass=inv_mass, mesh=mesh)
        samples[i] = target.generated(res.q)
        diags[i - 1] = res.diagnostics
        if collect_orbit_stats:
            orbit.append((res.orbit_min, res.orbit_max))
    if collect_orbit_stats:
        omin, omax = (torch.stack(x) for x in zip(*orbit))
        return samples, diags, state, omin, omax
    return samples, diags, state


def sampler_state_from_numpy(d, device="cpu") -> SamplerState:
    """A JAX ``SamplerState`` (the named tuple of arrays, or a mapping
    ``{field: array}`` with ``p2`` a mapping or named tuple) -> the
    port's state on ``device``, so that a run started in JAX continues
    in the port."""
    d = d._asdict() if hasattr(d, "_asdict") else d
    pv = d["p2"]._asdict() if hasattr(d["p2"], "_asdict") else d["p2"]

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return SamplerState(
        q=t(d["q"]), lp=t(d["lp"]), g=t(d["g"]), h=t(d["h"]),
        delta=t(d["delta"]),
        p2=P2State(**{f: t(pv[f]) for f in P2State._fields}),
        err_facs=t(d["err_facs"]), iter_n=int(np.asarray(d["iter_n"])))


def sampler_state_to_numpy(st: SamplerState) -> dict:
    """The port's state -> ``{field: numpy array}`` in the JAX
    ``SamplerState``'s dtypes (``iter_n`` int32; ``p2`` a dict)."""
    out = {}
    for name in SamplerState._fields:
        v = getattr(st, name)
        if name == "iter_n":
            out[name] = np.asarray(v, np.int32)
        elif name == "p2":
            out[name] = {f: getattr(v, f).cpu().numpy()
                         for f in P2State._fields}
        else:
            out[name] = v.cpu().numpy()
    return out
