"""Streaming (continuous-batching) WALNUTS engine
(``walnuts_tpu/sampler/streaming.py``).

The scan engine (:mod:`.driver`) waits at every transition for the
deepest orbit of the batch.  Here the transition loop is flattened
across iterations: every chain carries its own schedule row ``t`` and
iteration counter ``it``; each round advances every chain by one row of
the orbit schedule (a pair of macro steps and its U-turn checks), and a
chain that finishes a transition records its sample and 24-column
diagnostics row and starts its next orbit in the same round.  The loop
ends when every chain has ``num_iter`` transitions; only the tail runs
part-full.

Per chain the semantics are :func:`.transition.walnuts_transition`'s
(same integrators, stop codes and diagnostics), with two differences
from the scan engine: the tuning is fixed for the run (warm up with the
scan engine, then stream), and the randomness defaults to
``rng="hash"``.  There every draw is a splitmix32 hash of (seed, chain
id, the chain's own ``it`` and ``t``, purpose), the fused engine's hash
with other counters and purposes: a chain's draws do not depend on the
batch.  ``rng="global"`` keys each round's threefry draws by the round
number, so a chain's path depends on the whole batch's progress.

With the chains split over the ranks of a mesh (``mesh=``) every draw
is keyed by the global chain (the hash's chain id ``c0 + c``, the
threefry draws' row window), and no step pools anything across chains,
so the chain ranks need no collective: a rank's results are its rows of
the single-process run.  On a ``(chains, dim)`` mesh the run is inside
:func:`..parallel.mesh.dim_split`: the momentum is the rank's columns of
the whole draw (the hash's lanes are the global columns ``d0 ..``, the
threefry draw's column window), and the energies, the U-turn and merge
dots and the integrators' errors are dim-group sums and maxima, so each
per-chain flag the host loop reads is the same on every rank of the
group.

The round is the JAX loop body, with every per-chain schedule lookup a
gather from tables built once on the host.  The loop is a host loop
with one host sync per round (``any(it < num_iter)``), plus those of the
integrators' refinement sweeps.
"""

import numpy as np
import torch

from ..ops.hamiltonian import hamiltonian, refresh_momentum, uturn
from ..ops.integrators import get_integrator
from ..parallel.mesh import chain_block, col_window, dim_split, dim_sum
from ..utils import threefry
from ..utils.constants import LOG_ZERO, WT_SUM_THRESH
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .megakernel import (_M32, _TWO_PI, _U_OFF, _U_SC, HASH_M1, HASH_M2,
                         HASH_M3, _mix32, _mul32)
from .plans import build_schedule
from .transition import WalnutsConfig

_BIG_I32 = 2 ** 30

# the per-chain scalar fields of a round's state, with their reset
# values at a fresh transition ("h0": the fresh Hamiltonian)
_SCALARS = dict(
    mscale="h0", lwt_sum_f=0.0, lwt_sum_b=0.0, w_new_sum=0.0, w_old_sum=1.0,
    sel_l=0, sel_l_old=0, idx_time=0.0, index_stat=0.0, index_stat_old=0.0,
    time_f=0.0, time_b=0.0, orbit_len=0.0, orbit_len_sam=0.0, a_abs=0,
    b_abs=0, depth_done=False, stop_code=0, both_ends_passive=False,
    n_doubl_sampled=0, n_doubl_computed=0, max_f_int=0, max_b_int=0,
    neval_f=0, neval_b=0, h_min="h0", h_max="h0", if_min=_BIG_I32,
    if_max=-_BIG_I32, c_min=_BIG_I32, c_max=-_BIG_I32, lwt_min=np.inf,
    lwt_max=-np.inf, n_states=0, n_if_neq_ib=0, n_if_zero=0)


class _Tables:
    """The schedule's per-row tables on the device, built once."""

    def __init__(self, m, dev):
        sched = build_schedule(m)
        T, S = sched.n_steps, sched.capacity
        # every merge check's right endpoint is the row's just-integrated
        # rel2 state, so the only slab reads are the span-start slots: a
        # [T, S] mask fuses all of a row's checks into one reduction
        check = np.zeros((T, S), bool)
        for t in range(T):
            for k in range(sched.max_post):
                if sched.post_valid[t, k]:
                    check[t, sched.post_slot_lo[t, k]] = True
        # rel1 states are span starts worth storing only when rel1 == 1
        # (mod 4) at depths >= 2; rel2 (even) is never read back
        store1 = (sched.rel1 % 4 == 1) & (sched.depth >= 2)
        first = np.r_[True, sched.depth[1:] != sched.depth[:-1]]
        # the current depth's final row: a chain whose suborbit already
        # U-turned jumps straight to the depth-end resolution
        last_idx = np.zeros(T, np.int64)
        for d in range(m):
            rows = np.where(sched.depth == d)[0]
            last_idx[rows] = rows[-1]

        def i(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        def b(x):
            return torch.as_tensor(np.asarray(x, bool), device=dev)

        self.T, self.S = T, S
        self.depth, self.rel1, self.rel2 = (i(sched.depth), i(sched.rel1),
                                            i(sched.rel2))
        self.slot1, self.slot2 = i(sched.slot1), i(sched.slot2)
        self.last, self.is_d0 = b(sched.last_of_depth), b(sched.is_depth0)
        self.first, self.store1, self.check = b(first), b(store1), b(check)
        self.last_idx = i(last_idx)


def _hash_seed(seed):
    """The JAX engine's hash seed: ``randint(fold_in(PRNGKey(seed),
    777), (1,), 0, 2^30, int32)[0]``."""
    key = threefry.fold_in(threefry.PRNGKey(seed), 777)
    return int(threefry.randint(key, (1,), 0, 2 ** 30, torch.int32)[0])


def _make_hash_draws(seed, C, D, dtype, dev, c0=0, d0=0):
    """``draws(it, t)``: a round's draws keyed by (seed, chain id, the
    chain's ``it`` and ``t``, purpose): uniforms for the two jitters
    (purposes 0, 1), the two R2P coins (2, 3), the two category draws
    (4, 5) and the acceptance (6), the direction bits (7) and the
    Box-Muller momentum (8, 9).  The chain ids are ``c0 .. c0+C-1``, the
    momentum's lanes the columns ``d0 .. d0+D-1``."""
    cid = torch.arange(c0, c0 + C, dtype=torch.int64, device=dev)
    h_c = _mix32(((seed & _M32) + _mul32(cid, HASH_M1)) & _M32)
    lane_m1 = _mul32(torch.arange(d0, d0 + D, dtype=torch.int64,
                                  device=dev), HASH_M1)

    def to_f(x):
        return (x >> 8).to(dtype)

    def draws(it, t):
        h_it = _mix32((h_c + _mul32(it, HASH_M2)) & _M32)
        h_r = _mix32((h_it + _mul32(t, HASH_M1)) & _M32)

        def bits(p):
            return _mix32((h_r + ((p * HASH_M3) & _M32)) & _M32)

        u = [to_f(bits(p)) * _U_SC for p in range(7)]
        b1 = _mix32((h_r[:, None] + ((8 * HASH_M3) & _M32) + lane_m1)
                    & _M32)
        b2 = _mix32((h_r[:, None] + ((9 * HASH_M3) & _M32) + lane_m1)
                    & _M32)
        u1 = to_f(b1) * _U_SC + _U_OFF
        u2 = to_f(b2) * _U_SC
        mom = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
        return dict(h1=u[0], h2=u[1], i1=u[2], i2=u[3], c1=u[4], c2=u[5],
                    acc=u[6], dirs=bits(7), mom=mom)

    return draws


def run_walnuts_streaming(seed, q0, h_step, delta, *, target,
                          cfg: WalnutsConfig, num_iter: int,
                          rng: str = "hash", device=DEFAULT_DEVICE,
                          stats=None, mesh=None):
    """Stream ``num_iter`` fixed-tuning WALNUTS transitions per chain
    (``run_walnuts_streaming(jax.random.PRNGKey(seed), ...)`` of the JAX
    package).

    Args:
        seed: the int that JAX's ``PRNGKey`` takes.  Under ``rng="hash"``
            the hash seed is derived from it as the JAX engine derives
            it; under ``rng="global"`` round ``n`` draws from
            ``fold_in(PRNGKey(seed), n)``.
        q0: ``[C, D]`` initial positions (a tensor or a numpy array);
            dtype comes from it.
        h_step, delta: per-chain tuning ``[C]`` (fixed for the run).
        target, cfg: as for the scan engine.
        rng: ``"hash"`` (default) or ``"global"``.
        device: where to run; the card unless the caller passes
            ``device="cpu"``; without a card the default raises.
        stats: an optional dict; the number of rounds is stored under
            ``"rounds"``.
        mesh: a 1-D mesh (:func:`..parallel.make_mesh`): ``q0``,
            ``h_step`` and ``delta`` are this rank's block of chains
            (:func:`..parallel.shard_chains`), and the outputs are its
            rows of the single-process run's (the round count is the
            rank's own).  On a ``(chains, dim)`` mesh
            (:func:`..parallel.make_mesh2`) ``q0`` is this rank's (chain
            rows, column block) (:func:`..parallel.shard_chains_dim`)
            and the rank returns its block, as ``run_walnuts`` does:
            samples of an identity ``generated`` and ``q_final`` hold
            the rank's columns, the diagnostics whole rows
            (:func:`..diagnostics.gather_blocks` joins both axes).

    Returns ``(samples [num_iter, C, dg], diagnostics [num_iter, C,
    24], q_final [C, D])``.  Restarting from ``q_final`` is exact (every
    transition begins with a momentum refresh), so long runs can be
    chunked.
    """
    dev = resolve_device(device)
    q0 = torch.as_tensor(q0).to(dev)
    dtype = q0.dtype
    h_step = torch.as_tensor(h_step).to(device=dev, dtype=dtype)
    delta = torch.as_tensor(delta).to(device=dev, dtype=dtype)
    if not 1 <= cfg.m <= 32:
        # direction draws come from one 32-bit word per transition
        raise ValueError(f"cfg.m must be in [1, 32], got {cfg.m}")
    if rng not in ("hash", "global"):
        raise ValueError(f"rng must be 'hash' or 'global', got {rng!r}")
    with dim_split(mesh, target.dim):
        return _stream(seed, q0, h_step, delta, target, cfg, num_iter, rng,
                       stats, chain_block(mesh, q0.shape[0]))


def _stream(seed, q0, h_step, delta, target, cfg, num_iter, rng, stats,
            block):
    """:func:`run_walnuts_streaming`'s rounds on the rank's block, its
    chains ``c0 ..`` of ``C_total`` (``block``)."""
    dev, dtype = q0.device, q0.dtype
    C, D = q0.shape
    c0, C_total = block
    rows = (c0, c0 + C) if C_total != C else None
    D_total, d_win = col_window(D)
    d0 = d_win[0] if d_win else 0
    m = cfg.m
    tab = _Tables(m, dev)
    T, S = tab.T, tab.S
    integrator = get_integrator(cfg.integrator)
    W = torch.where

    lp0, g0 = target.logp_grad(q0)
    zf = torch.zeros((C,), dtype=dtype, device=dev)
    thresh = torch.tensor(WT_SUM_THRESH, dtype=dtype, device=dev)
    log_zero_edge = LOG_ZERO + 1.0
    ar = torch.arange(C, device=dev)
    m_bits = torch.arange(m, dtype=torch.int64, device=dev)

    def full(v):
        if isinstance(v, bool):
            return torch.full((C,), v, dtype=torch.bool, device=dev)
        if isinstance(v, int):
            return torch.full((C,), v, dtype=torch.int32, device=dev)
        return torch.full((C,), v, dtype=dtype, device=dev)

    st = {k: (zf if v == "h0" else full(v)) for k, v in _SCALARS.items()}
    st.update(
        t=torch.zeros((C,), dtype=torch.int64, device=dev),
        it=torch.zeros((C,), dtype=torch.int64, device=dev),
        qp=q0, vp=torch.zeros_like(q0), gp=g0, lpp=lp0, hp=zf,
        qm=q0, vm=torch.zeros_like(q0), gm=g0, lpm=lp0, hm=zf,
        qc=q0, lpc=lp0, gc=g0,
        q_prop=q0, lp_prop=lp0, g_prop=g0,
        q_prop_last=q0, lp_prop_last=lp0, g_prop_last=g0,
        xi_all=torch.ones((C, m), dtype=dtype, device=dev),
        slab_q=torch.zeros((C, S, D), dtype=dtype, device=dev),
        slab_v=torch.zeros((C, S, D), dtype=dtype, device=dev))
    gen_probe = target.generated(q0)
    samples = torch.zeros((num_iter,) + tuple(gen_probe.shape),
                          dtype=gen_probe.dtype, device=dev)
    diags = torch.zeros((num_iter, C, 24), dtype=dtype, device=dev)

    if rng == "hash":
        hash_draws = _make_hash_draws(_hash_seed(seed), C, D, dtype, dev, c0,
                                      d0)
    else:
        key = threefry.PRNGKey(seed, dev)

    def integrate(coin, u, hloc, xi, fwd, rel, slot, active, is_d0, store):
        """One macro step from each chain's active end, with all
        bookkeeping (the JAX ``_integrate``)."""
        f1 = fwd[:, None]
        res = integrator(coin, target, W(f1, st["qp"], st["qm"]),
                         W(f1, st["vp"], st["vm"]), W(f1, st["gp"], st["gm"]),
                         W(fwd, st["lpp"], st["lpm"]),
                         W(fwd, st["hp"], st["hm"]), hloc, xi, delta, None,
                         active, cfg.igr)
        finite = torch.isfinite(res.h_end)
        ok = active & finite
        af, ab = active & fwd, active & ~fwd
        abs_id = W(fwd, st["b_abs"] + rel, st["a_abs"] - rel).to(torch.int32)

        lwt_sum_f = st["lwt_sum_f"] + W(ok & fwd, res.lwt, 0.0)
        lwt_sum_b = st["lwt_sum_b"] + W(ok & ~fwd, res.lwt, 0.0)
        lwt_dir = W(fwd, lwt_sum_f, lwt_sum_b)
        w_new = torch.exp(-res.h_end + st["mscale"] + lwt_dir)
        w_new_sum = st["w_new_sum"] + W(ok, w_new, 0.0)
        sel = (ok & (w_new_sum > thresh) & (u * w_new_sum < w_new)
               & ~is_d0) | (ok & is_d0)
        time_f = st["time_f"] + W(af, hloc, 0.0)
        time_b = st["time_b"] + W(ab, hloc, 0.0)
        signed_time = W(fwd, time_f, -time_b)
        olen_mask = W(is_d0, active, ok)

        af1, ab1, sel1 = af[:, None], ab[:, None], sel[:, None]
        # per-chain slot writes as a one-hot masked select; ``store``
        # masks the states that are never read back
        put = (((ok & store)[:, None]
                & (torch.arange(S, device=dev)[None, :] == slot[:, None]))
               [:, :, None])
        st.update(
            qp=W(af1, res.q, st["qp"]), vp=W(af1, res.v, st["vp"]),
            gp=W(af1, res.g, st["gp"]), lpp=W(af, res.lp, st["lpp"]),
            hp=W(af, res.h_end, st["hp"]),
            qm=W(ab1, res.q, st["qm"]), vm=W(ab1, res.v, st["vm"]),
            gm=W(ab1, res.g, st["gm"]), lpm=W(ab, res.lp, st["lpm"]),
            hm=W(ab, res.h_end, st["hm"]),
            neval_f=st["neval_f"] + W(active, res.n_eval_f, 0),
            neval_b=st["neval_b"] + W(active, res.n_eval_b, 0),
            h_min=W(active, torch.minimum(st["h_min"], res.h_end),
                    st["h_min"]),
            h_max=W(active, torch.maximum(st["h_max"], res.h_end),
                    st["h_max"]),
            if_min=W(active, torch.minimum(st["if_min"], res.i_f),
                     st["if_min"]),
            if_max=W(active, torch.maximum(st["if_max"], res.i_f),
                     st["if_max"]),
            c_min=W(active, torch.minimum(st["c_min"], res.c), st["c_min"]),
            c_max=W(active, torch.maximum(st["c_max"], res.c), st["c_max"]),
            lwt_min=W(active, torch.minimum(st["lwt_min"], res.lwt),
                      st["lwt_min"]),
            lwt_max=W(active, torch.maximum(st["lwt_max"], res.lwt),
                      st["lwt_max"]),
            n_states=st["n_states"] + active.to(torch.int32),
            n_if_neq_ib=st["n_if_neq_ib"]
            + (active & (res.i_f != res.i_b)).to(torch.int32),
            n_if_zero=st["n_if_zero"]
            + (active & (res.i_f == 0)).to(torch.int32),
            max_f_int=W(af, abs_id, st["max_f_int"]),
            max_b_int=W(ab, abs_id, st["max_b_int"]),
            time_f=time_f, time_b=time_b, lwt_sum_f=lwt_sum_f,
            lwt_sum_b=lwt_sum_b, w_new_sum=w_new_sum,
            q_prop=W(sel1, res.q, st["q_prop"]),
            lp_prop=W(sel, res.lp, st["lp_prop"]),
            g_prop=W(sel1, res.g, st["g_prop"]),
            sel_l=W(sel, abs_id, st["sel_l"]),
            idx_time=W(sel, signed_time, st["idx_time"]),
            orbit_len=st["orbit_len"] + W(olen_mask, hloc, 0.0),
            slab_q=W(put, res.q[:, None, :], st["slab_q"]),
            slab_v=W(put, res.v[:, None, :], st["slab_v"]),
        )
        return res.q, res.v, finite, ok

    s_jit = cfg.step_size_rand_scale
    no_store = torch.zeros((C,), dtype=torch.bool, device=dev)
    n = 0
    while bool((st["it"] < num_iter).any()):
        live = st["it"] < num_iter
        if rng == "hash":
            rr = hash_draws(st["it"], st["t"])
            coins = (rr["i1"], rr["i2"])
            u_cat = (rr["c1"], rr["c2"])
            u_acc = rr["acc"]
            hloc = h_step[:, None] * (
                (1.0 - s_jit)
                + torch.stack([rr["h1"], rr["h2"]], 1) * (2.0 * s_jit))
        else:
            (k_h, k_i1, k_i2, k_c1, k_c2, k_acc, k_mom,
             k_dirs) = threefry.split(threefry.fold_in(key, n), 8).unbind(-2)
            if cfg.integrator == "adapt_leapfrog_r2p":
                coins = tuple(threefry.uniform(k, (C_total,), torch.float64,
                                               rows=rows)
                              for k in (k_i1, k_i2))
            else:  # the other integrators draw nothing
                coins = (None, None)
            u_cat = tuple(threefry.uniform(k, (C_total,), dtype, rows=rows)
                          for k in (k_c1, k_c2))
            u_acc = threefry.uniform(k_acc, (C_total,), dtype, rows=rows)
            hloc = h_step[:, None] * threefry.uniform(
                k_h, (C_total, 2), dtype, 1.0 - s_jit, 1.0 + s_jit, rows)

        # ---- fresh-transition initialisation (t == 0) ----
        fresh = live & (st["t"] == 0)
        if rng == "hash":
            v0 = rr["mom"].to(dtype)
            bits = (rr["dirs"][:, None] >> m_bits[None, :]) & 1
            xi_new = W(bits != 0, 1.0, -1.0).to(dtype)
        else:
            v0 = refresh_momentum(k_mom, (C_total, D_total), None, dtype,
                                  rows, d_win)
            xi_new = W(threefry.bernoulli(k_dirs, 0.5, (C_total, m),
                                          rows=rows), 1.0, -1.0).to(dtype)
        h0 = hamiltonian(st["lpc"], v0)
        f1 = fresh[:, None]
        for k, v in _SCALARS.items():
            st[k] = W(fresh, h0 if v == "h0" else v, st[k])
        for e in ("p", "m"):
            st["q" + e] = W(f1, st["qc"], st["q" + e])
            st["v" + e] = W(f1, v0, st["v" + e])
            st["g" + e] = W(f1, st["gc"], st["g" + e])
            st["lp" + e] = W(fresh, st["lpc"], st["lp" + e])
            st["h" + e] = W(fresh, h0, st["h" + e])
        for e in ("", "_last"):
            st["q_prop" + e] = W(f1, st["qc"], st["q_prop" + e])
            st["lp_prop" + e] = W(fresh, st["lpc"], st["lp_prop" + e])
            st["g_prop" + e] = W(f1, st["gc"], st["g_prop" + e])
        st["xi_all"] = W(f1, xi_new, st["xi_all"])

        # ---- per-chain schedule row ----
        t = st["t"]
        depth_t = tab.depth[t]
        last, is_d0, first = tab.last[t], tab.is_d0[t], tab.first[t]
        xi = torch.gather(st["xi_all"], 1, depth_t[:, None])[:, 0]
        fwd = xi > 0

        # depth-start snapshot
        snap = live & first & ~is_d0
        s1 = snap[:, None]
        st.update(
            q_prop_last=W(s1, st["q_prop"], st["q_prop_last"]),
            lp_prop_last=W(snap, st["lp_prop"], st["lp_prop_last"]),
            g_prop_last=W(s1, st["g_prop"], st["g_prop_last"]),
            sel_l_old=W(snap, st["sel_l"], st["sel_l_old"]),
            index_stat_old=W(snap, st["index_stat"], st["index_stat_old"]),
            w_new_sum=W(snap | (live & first & is_d0), 0.0,
                        st["w_new_sum"]))

        alive = live & ~st["depth_done"]
        q1, v1, finite1, ok1 = integrate(
            coins[0], u_cat[0], hloc[:, 0], xi, fwd, tab.rel1[t],
            tab.slot1[t], alive, is_d0, tab.store1[t])
        forced1 = alive & ~finite1
        act2 = ok1 & ~is_d0
        q2, v2, finite2, ok2 = integrate(
            coins[1], u_cat[1], hloc[:, 1], xi, fwd, tab.rel2[t],
            tab.slot2[t], act2, no_store, no_store)
        forced = forced1 | (act2 & ~finite2)

        # adjacent U-turn
        fw1 = fwd[:, None]
        adj_ut = uturn(W(fw1, q1, q2), W(fw1, v1, v2), W(fw1, q2, q1),
                       W(fw1, v2, v1))
        depth_done = st["depth_done"] | (ok2 & adj_ut)

        # merge checks: all of this row's span-start slots against the
        # just-integrated state (q2, v2) in one [C, S, D] reduction; with
        # d_f = q2 - slab_q the time orientation only flips the signs
        d_f = q2[:, None, :] - st["slab_q"]
        dot_new, dot_old = dim_sum(torch.sum(v2[:, None, :] * d_f, dim=-1),
                                   torch.sum(st["slab_v"] * d_f, dim=-1))
        ut_all = W(fw1, (dot_new < 0.0) | (dot_old < 0.0),
                   (dot_new > 0.0) | (dot_old > 0.0))
        merge_ut = torch.any(tab.check[t] & ut_all, dim=1)
        st["depth_done"] = depth_done | (ok2 & merge_ut)
        st["stop_code"] = W(forced, 999, st["stop_code"])
        done = forced

        # ---- depth-end resolution ----
        p_mask = live & last & ~done
        su = p_mask & st["depth_done"]
        go = p_mask & ~st["depth_done"]
        keep_new = u_acc * st["w_old_sum"] < st["w_new_sum"]
        restore = su | (go & ~keep_new)
        r1 = restore[:, None]
        st.update(
            q_prop=W(r1, st["q_prop_last"], st["q_prop"]),
            lp_prop=W(restore, st["lp_prop_last"], st["lp_prop"]),
            g_prop=W(r1, st["g_prop_last"], st["g_prop"]),
            sel_l=W(restore, st["sel_l_old"], st["sel_l"]),
            index_stat=W(restore, st["index_stat_old"], W(
                p_mask, st["idx_time"] / (st["time_f"] + st["time_b"]),
                st["index_stat"])))
        depth_i = depth_t.to(torch.int32)
        st.update(
            n_doubl_sampled=W(su, depth_i, st["n_doubl_sampled"]),
            n_doubl_computed=W(su, depth_i + 1, st["n_doubl_computed"]),
            stop_code=W(su, 5, st["stop_code"]))
        done = done | su

        joined = uturn(st["qm"], st["vm"], st["qp"], st["vp"])
        passive = ((st["lwt_sum_b"] < log_zero_edge)
                   & (st["lwt_sum_f"] < log_zero_edge))
        stop_now = go & (joined | passive)
        st.update(
            n_doubl_sampled=W(go, depth_i + 1, st["n_doubl_sampled"]),
            n_doubl_computed=W(go, depth_i + 1, st["n_doubl_computed"]),
            orbit_len_sam=W(go, st["orbit_len"], st["orbit_len_sam"]),
            both_ends_passive=W(go, passive, st["both_ends_passive"]),
            stop_code=W(stop_now, W(joined, 4, -4).to(torch.int32),
                        st["stop_code"]))
        done = done | stop_now

        cont = go & ~stop_now
        pw = torch.ones_like(depth_i) << depth_i
        done = done | (cont & (t + 1 >= T))
        st.update(
            w_old_sum=W(cont, st["w_old_sum"] + st["w_new_sum"],
                        st["w_old_sum"]),
            b_abs=W(cont & fwd, st["b_abs"] + pw, st["b_abs"]),
            a_abs=W(cont & ~fwd, st["a_abs"] - pw, st["a_abs"]),
            depth_done=W(last, False, st["depth_done"]))
        done = done & live

        # ---- record the transitions that finish now ----
        either_passive = ((st["lwt_sum_b"] < log_zero_edge)
                          | (st["lwt_sum_f"] < log_zero_edge))
        nst = torch.clamp(st["n_states"], min=1).to(dtype)
        cols = [
            st["sel_l"], st["n_doubl_sampled"], st["orbit_len"],
            st["orbit_len_sam"], st["max_f_int"], st["max_b_int"],
            st["neval_f"], st["neval_b"], st["if_min"], st["if_max"],
            st["lwt_min"], st["lwt_max"], st["both_ends_passive"],
            either_passive, st["n_if_neq_ib"].to(dtype) / nst, h_step,
            st["n_if_zero"].to(dtype) / nst, st["h_max"] - st["h_min"],
            delta, st["stop_code"], st["n_doubl_computed"], st["c_min"],
            st["c_max"], st["index_stat"]]
        diag_row = torch.stack([x.to(dtype) for x in cols], dim=-1)
        # each chain's row is its own ``it``: only the finishing chains'
        # rows change (the others write back what is there), and no
        # index leaves the buffer
        row = torch.clamp(st["it"], max=num_iter - 1)
        d1 = done[:, None]
        samples[row, ar] = W(d1, target.generated(st["q_prop"]),
                             samples[row, ar])
        diags[row, ar] = W(d1, diag_row, diags[row, ar])

        # advance: finished chains restart at t=0 from the proposal;
        # depth-done chains skip to their depth's resolution row
        t_next = W(st["depth_done"] & ~last, tab.last_idx[t], t + 1)
        st.update(
            t=W(done | ~live, 0, t_next),
            it=st["it"] + done.to(torch.int64),
            qc=W(d1, st["q_prop"], st["qc"]),
            lpc=W(done, st["lp_prop"], st["lpc"]),
            gc=W(d1, st["g_prop"], st["gc"]))
        n += 1
    if stats is not None:
        stats["rounds"] = n
    return samples, diags, st["qc"]
