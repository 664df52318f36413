"""Fixed-orbit-length multinomial sampler with the WASPS stop rule
(``walnuts_tpu/sampler/multinomial.py``, after the reference's
``isokinetic/samplers.py:59-292``).

* The orbit length ``L`` is fixed; the forward/backward split is random,
  ``nf ~ U{0..L-1}``, ``nb = L - 1 - nf``.
* Per direction, macro steps from a pluggable step kernel
  (:mod:`.kernels`) accumulate a log-weight sum; a direction dies when
  the sum falls below ``LOG_ZERO + 10``.
* **WASPS stop** (random-plane crossing): with per-iteration random
  directions ``eta`` (scaled by ``1/||z||^2``) and ``gam``
  (orthogonalised against ``eta``), a direction stops when the ``eta``
  projection of ``q - center`` changes sign across a step and the
  ``gam`` projection is positive at either end.
* Online multinomial selection with weights ``exp(Ham_0 - Ham_i +
  accLogWtSum)`` against a running sum seeded by the centre state's
  unit weight, in log space.
* Warmup: ``delta`` by dual averaging toward an ESS-fraction target and
  ``hMacro = (delta / exp(P2_q(log Cobs)))^(1/3)``.
* Optional per-coordinate pre-scaling ``scale`` and whole-orbit min/max
  statistics.

JAX's ``lax.scan`` over iterations and the sweeps' ``while_loop``s are
host loops (one host sync per sweep step).  Randomness is JAX's
threefry stream (with x64 on, so the forward split is drawn as int64).
With the chains split over the ranks of a mesh every draw is the rank's
rows of the whole batch's; each chain adapts on its own, so the chain
ranks need no collective.  On a ``(chains, dim)`` mesh the run is inside
:func:`..parallel.mesh.dim_split`: the momentum and the WASPS directions
are the rank's columns of the whole draws, their norms and the four
WASPS projections are dim-group sums, and ``scale`` and ``center`` are
taken at the rank's columns.
"""

from typing import NamedTuple

import torch

from ..ops.isokinetic import draw_window, where_state
from ..parallel.mesh import chain_block, chain_ranks, dim_split, dim_sum
from ..utils import threefry
from ..utils.constants import LOG_ZERO
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.dual_average import da_init, da_observe, da_par
from ..utils.p2 import p2_init, p2_push, p2_quantile
from .generic_nuts import logaddexp
from .kernels import IsokineticKernel

DIAG_COLS = ["h", "numForw", "sampleIndex", "deF", "deB", "lwtRange",
             "nSteps", "ESSfrac", "delta", "gradEvals", "energyErr",
             "minIf", "maxIf", "propBasic"]


class MultinomialConfig(NamedTuple):
    """Static configuration (``multinomialSampler`` kwargs)."""

    l_orbit: int = 20
    wasps: bool = True
    ess_target: float = 0.99
    basic_target: float = 0.9


class _Scaled:
    """The target in pre-scaled coordinates ``q / scale``: the step
    kernels read only ``logp_grad``.  ``svec`` is the scale at the
    batch's columns (a rank's window under a dim split); ``dim`` is the
    target's whole D."""

    def __init__(self, target, svec):
        self.target, self.svec, self.dim = target, svec, target.dim

    def logp_grad(self, q):
        lp, g = self.target.logp_grad(q * self.svec)
        return lp, g * self.svec


def _wasps_vectors(key, shape, dtype, rows=None, cols=None):
    """``eta``, ``gam`` (note the ``1/||z||^2`` scaling: magnitudes
    cancel in the sign-based stop rule); ``rows`` of ``shape``'s
    leading axis and ``cols`` of its last alone, every sum over D the
    dim group's."""
    k1, k2 = threefry.split(key).unbind(-2)
    z1 = threefry.normal(k1, shape, dtype, rows, cols)
    z2 = threefry.normal(k2, shape, dtype, rows, cols)
    eta = z1 / dim_sum(torch.sum(z1 * z1, dim=-1, keepdim=True))
    z2 = z2 - dim_sum(torch.sum(z2 * eta, dim=-1, keepdim=True)) * eta
    gam = z2 / dim_sum(torch.sum(z2 * z2, dim=-1, keepdim=True))
    return eta, gam


class _Sweep(NamedTuple):
    log_mn_sum: torch.Tensor     # log of this direction's weight sum
    q_sel: torch.Tensor
    lp_sel: torch.Tensor
    g_sel: torch.Tensor
    idx_sel: torch.Tensor
    n_done: torch.Tensor
    dead: torch.Tensor
    lwt_min: torch.Tensor
    lwt_max: torch.Tensor
    sum_w: torch.Tensor          # direct sum of normalised weights
    sum_w2: torch.Tensor
    n_used: torch.Tensor
    n_evals: torch.Tensor
    cobs_p2: torch.Tensor
    omin: torch.Tensor
    omax: torch.Tensor


def _direction_sweep(key, target, kernel, s0, ham0, n_steps, h, delta,
                     eta, gam, cen, cfg, sign, orbit_min, orbit_max,
                     gen_fn, block=None):
    """One direction's masked sweep of up to ``max(n_steps)`` macro
    steps: the selected state and index (online multinomial within this
    direction, merged across directions by the caller), the log weight
    sum, per-direction stats and the updated orbit stats.  ``block = (c0,
    C_total)``: the chains are rows ``c0 ..`` of the whole batch."""
    C = s0.q.shape[0]
    u_shape, rows, _ = draw_window((C,), block)
    dtype, dev = s0.q.dtype, s0.q.device
    W = torch.where
    zf = torch.zeros((C,), dtype=dtype, device=dev)
    zi = torch.zeros((C,), dtype=torch.int32, device=dev)
    zb = torch.zeros((C,), dtype=torch.bool, device=dev)
    s, stopped, dead, acc_lwt = s0, zb, zb, zf
    log_mn_sum = torch.full((C,), -torch.inf, dtype=dtype, device=dev)
    q_sel, lp_sel, g_sel, idx_sel = s0.q, s0.lp, s0.g, zi
    n_done, n_used, n_evals = zi, zi, zi
    lwt_min = torch.full((C,), torch.inf, dtype=dtype, device=dev)
    lwt_max = -lwt_min
    sum_w, sum_w2, cobs_p2 = zf, zf, zf
    omin, omax = orbit_min, orbit_max
    i = 0
    while True:
        active = (i < n_steps) & ~stopped & ~dead
        if not bool(active.any()):
            break
        key_step, key_sel, key = threefry.split(key, 3).unbind(-2)
        q_old = s.q
        s_new, lwt_step, stats = kernel.step(key_step, target, s, h, delta,
                                             active)
        acc_lwt = acc_lwt + W(active, lwt_step, 0.0)
        dead = dead | (active & (acc_lwt < LOG_ZERO + 10.0))

        # WASPS plane-crossing stop (``samplers.py:180-188``)
        if cfg.wasps:
            cqs = s_new.q - cen
            cq = q_old - cen
            p1s, p1, p2s, p2 = dim_sum(
                torch.sum(cqs * eta, dim=-1), torch.sum(cq * eta, dim=-1),
                torch.sum(cqs * gam, dim=-1), torch.sum(cq * gam, dim=-1))
            stop_now = active & ~dead & (p1s * p1 < 0.0) & (
                torch.maximum(p2s, p2) > 0.0)
        else:
            stop_now = zb
        stopped = stopped | stop_now

        # states that died or stopped contribute no weight
        use = active & ~dead & ~stop_now
        ham_new = kernel.ham(s_new)
        lwt = W(use & torch.isfinite(ham_new), ham0 - ham_new + acc_lwt,
                -torch.inf)
        log_mn_sum = W(use, logaddexp(log_mn_sum, lwt), log_mn_sum)
        u = threefry.uniform(key_sel, u_shape, dtype, rows=rows)
        sel = use & (torch.log(torch.clamp(u, min=1e-300))
                     < lwt - log_mn_sum)

        w = W(use, torch.exp(torch.clamp(lwt, max=80.0)), 0.0)
        s = where_state(active, s_new, s)
        if gen_fn is not None:
            gen = gen_fn(s_new.q)
            u1 = use[:, None]
            omin = W(u1, torch.minimum(omin, gen), omin)
            omax = W(u1, torch.maximum(omax, gen), omax)

        s1 = sel[:, None]
        q_sel = W(s1, s_new.q, q_sel)
        lp_sel = W(sel, s_new.lp, lp_sel)
        g_sel = W(s1, s_new.g, g_sel)
        idx_sel = W(sel, sign * (i + 1), idx_sel)
        n_done = n_done + use.to(torch.int32)
        lwt_min = W(use, torch.minimum(lwt_min, lwt), lwt_min)
        lwt_max = W(use, torch.maximum(lwt_max, lwt), lwt_max)
        sum_w = sum_w + w
        sum_w2 = sum_w2 + w * w
        n_used = n_used + use.to(torch.int32)
        n_evals = n_evals + stats.n_evals
        cobs_p2 = W(use, torch.maximum(cobs_p2, stats.c_obs), cobs_p2)
        i += 1
    return _Sweep(log_mn_sum, q_sel, lp_sel, g_sel, idx_sel, n_done, dead,
                  lwt_min, lwt_max, sum_w, sum_w2, n_used, n_evals, cobs_p2,
                  omin, omax)


def run_multinomial(seed, q0, *, target, kernel=IsokineticKernel(),
                    cfg: MultinomialConfig = MultinomialConfig(),
                    h0=0.1, delta0=0.1, num_iter: int = 1000,
                    warmup_iter: int = 500, scale=1.0, center=0.0,
                    collect_orbit_stats: bool = False,
                    device=DEFAULT_DEVICE, mesh=None):
    """Run the fixed-orbit multinomial sampler over a ``[C, D]`` batch
    (``wt.sampler.run_multinomial(jax.random.PRNGKey(seed), q0, ...)``).

    ``seed`` is an int (the key is ``PRNGKey(seed)``) or a threefry key.
    ``q0`` (a tensor or a numpy array), ``scale`` and ``center`` are
    moved to ``device``, the card unless the caller passes
    ``device="cpu"``; dtype comes from ``q0``.  Iteration ``it = 1 ..
    num_iter`` draws from ``fold_in(key, it)`` and adapts ``(h, delta)``
    while ``it <= warmup_iter``.

    ``mesh``: a 1-D mesh (:func:`..parallel.make_mesh`): ``q0`` is this
    rank's block of chains (:func:`..parallel.shard_chains`) and the
    outputs are its rows of the single-process run's.  On a ``(chains,
    dim)`` mesh (:func:`..parallel.make_mesh2`) ``q0`` is this rank's
    (chain rows, column block) (:func:`..parallel.shard_chains_dim`),
    ``scale`` and ``center`` are whole (scalars or ``[D]`` vectors), and
    the rank returns its block as ``run_walnuts`` does (samples and
    orbit statistics of an identity ``generated`` hold the rank's
    columns; :func:`..diagnostics.gather_blocks` joins both axes).

    Returns ``(samples [num_iter+1, C, dg], diagnostics [num_iter, C,
    14], (h, delta) final)``, plus the per-iteration orbit minima and
    maxima of the generated quantities under ``collect_orbit_stats``.
    """
    dev = resolve_device(device)
    key = (seed.to(device=dev, dtype=torch.int64)
           if isinstance(seed, torch.Tensor) else threefry.PRNGKey(seed, dev))
    q0 = torch.as_tensor(q0).to(dev)
    block = chain_block(mesh, q0.shape[0]) if chain_ranks(mesh) > 1 \
        else None
    with dim_split(mesh, target.dim):
        return _run(key, q0, target, kernel, cfg, h0, delta0, num_iter,
                    warmup_iter, scale, center, collect_orbit_stats, block)


def _run(key, q0, target, kernel, cfg, h0, delta0, num_iter, warmup_iter,
         scale, center, collect_orbit_stats, block):
    """:func:`run_multinomial`'s body on the rank's block."""
    C = q0.shape[0]
    dtype, dev = q0.dtype, q0.device
    (Cg, D), rows, cols = draw_window(q0.shape, block)
    d0, d1 = cols or (0, D)
    L = cfg.l_orbit
    W = torch.where

    svec = torch.as_tensor(scale, dtype=dtype).to(dev).expand(D)
    cen = (torch.as_tensor(center, dtype=dtype).to(dev).expand(D)
           / svec)[d0:d1]
    svec = svec[d0:d1]
    scaled = _Scaled(target, svec)

    state = kernel.init(scaled, q0 / svec)
    h = torch.full((C,), h0, dtype=dtype, device=dev)
    delta = torch.full((C,), delta0, dtype=dtype, device=dev)
    da = da_init(delta0, cfg.ess_target, (C,), dtype, dev)
    p2 = p2_init(cfg.basic_target, (C,), dtype, dev)
    gen_fn = ((lambda qq: target.generated(qq * svec))
              if collect_orbit_stats else None)

    gen_q0 = target.generated(q0)
    samples = torch.empty((num_iter + 1,) + tuple(gen_q0.shape),
                          dtype=gen_q0.dtype, device=dev)
    samples[0] = gen_q0
    diags = torch.empty((num_iter, C, len(DIAG_COLS)), dtype=dtype,
                        device=dev)
    omins, omaxs = [], []
    for it in range(1, num_iter + 1):
        k_mom, k_nf, k_wasps, k_f, k_b, k_pick = threefry.split(
            threefry.fold_in(key, it), 6).unbind(-2)
        s = kernel.refresh(k_mom, state, block)
        ham0 = kernel.ham(s)
        nf = threefry.randint(k_nf, (Cg,), 0, L, rows=rows)
        nb = L - 1 - nf
        eta = gam = None
        if cfg.wasps:
            eta, gam = _wasps_vectors(k_wasps, (Cg, D), dtype, rows, cols)
        gen0 = (target.generated(s.q * svec) if collect_orbit_stats
                else torch.zeros((C, 0), dtype=dtype, device=dev))

        fw = _direction_sweep(k_f, scaled, kernel, s, ham0, nf, h, delta,
                              eta, gam, cen, cfg, 1, gen0, gen0, gen_fn,
                              block)
        bw = _direction_sweep(k_b, scaled, kernel, kernel.flip(s), ham0, nb,
                              h, delta, eta, gam, cen, cfg, -1, fw.omin,
                              fw.omax, gen_fn, block)

        # merge the two directions' selections with the centre state,
        # whose weight is exp(0)
        log_fb = logaddexp(fw.log_mn_sum, bw.log_mn_sum)
        log_tot = logaddexp(torch.zeros_like(log_fb), log_fb)
        u = threefry.uniform(k_pick, (Cg,), dtype, rows=rows)
        lu = torch.log(torch.clamp(u, min=1e-300))
        pick_f = lu < fw.log_mn_sum - log_tot
        pick_b = ~pick_f & (lu < log_fb - log_tot)
        pf1, pb1 = pick_f[:, None], pick_b[:, None]
        q_new = W(pf1, fw.q_sel, W(pb1, bw.q_sel, s.q))
        lp_new = W(pick_f, fw.lp_sel, W(pick_b, bw.lp_sel, s.lp))
        g_new = W(pf1, fw.g_sel, W(pb1, bw.g_sel, s.g))
        idx = W(pick_f, fw.idx_sel, W(pick_b, bw.idx_sel, 0))
        # the next iteration refreshes the velocity, so store u = 0
        state = state._replace(q=q_new, u=torch.zeros_like(q_new), g=g_new,
                               lp=lp_new)

        # ESS fraction of the multinomial weights; the centre state
        # contributes weight 1
        sum_w = 1.0 + fw.sum_w + bw.sum_w
        sum_w2 = 1.0 + fw.sum_w2 + bw.sum_w2
        n_used = 1 + fw.n_used + bw.n_used
        ess_frac = sum_w * sum_w / (n_used.to(dtype) * sum_w2)

        lwt_min = torch.minimum(fw.lwt_min, bw.lwt_min)
        lwt_max = torch.maximum(fw.lwt_max, bw.lwt_max)
        lwt_range = W(torch.isfinite(lwt_min), lwt_max - lwt_min, 0.0)
        zf = torch.zeros((C,), dtype=dtype, device=dev)
        diags[it - 1] = torch.stack([
            h, nf.to(dtype), idx.to(dtype), fw.dead.to(dtype),
            bw.dead.to(dtype), lwt_range, (fw.n_done + bw.n_done).to(dtype),
            ess_frac, delta, (fw.n_evals + bw.n_evals).to(dtype),
            zf, zf, zf, zf], dim=-1)   # energyErr etc. live in the kernels
        samples[it] = target.generated(q_new * svec)
        if collect_orbit_stats:
            omins.append(bw.omin)
            omaxs.append(bw.omax)

        # warmup adaptation (``samplers.py:259-268``)
        if it <= warmup_iter:
            da = da_observe(da, ess_frac)
            cobs = torch.clamp(torch.maximum(fw.cobs_p2, bw.cobs_p2),
                               min=1e-30)
            p2 = p2_push(p2, torch.log(cobs))
            if it > 10:
                delta = da_par(da)
                h = (delta / torch.exp(p2_quantile(p2))) ** (1.0 / 3.0)
    if collect_orbit_stats:
        return (samples, diags, (h, delta), torch.stack(omins),
                torch.stack(omaxs))
    return samples, diags, (h, delta)
