"""The WALNUTS Markov transition of the scan engine
(``walnuts_tpu/sampler/transition.py``).

Semantics are the JAX version's, line for line: biased-progressive
orbit doubling with interleaved sub-U-turn checks, online categorical
proposal selection with ``LOG_ZERO`` weight guards, per-macro-step
step-size jitter, stop codes {0, 4, -4, 5, 999}, warmup statistics and
the 24-column diagnostics row (``WALNUTS.py:670-693``).

The orbit is the flat static schedule of :mod:`.plans`: step 0 is the
depth-0 macro step, every later step integrates one forward-or-backward
pair of macro steps, runs the adjacent U-turn check and the merge
checks against a ``[C, capacity, D]`` slab of checkpoints.  The step
loop is a Python loop that ends once every chain has stopped (one host
sync per step).  The schedule's tables are host values, so what JAX
decides with ``lax.cond`` on a traced scalar (the P2 push in warmup, a
merge check, the depth-end block, the depth-0 step's empty second macro
step) is a host ``if`` here.  Every state update is an out-of-place
``torch.where``, so no carried tensor aliases another.

Randomness is JAX's threefry stream (:mod:`..utils.threefry`), drawn as
the JAX version draws it: ``split(key, 3)`` into momentum, directions
and orbit keys; per schedule step ``t``, ``split(fold_in(k_orbit, t),
6)`` into the jitter, the two integrator coins, the two category
uniforms and the acceptance uniform.  All steps' draws are computed in
one batched pass before the loop; the bits are those of the per-step
draws.

Inside a dim split (:func:`..parallel.mesh.dim_split`) ``q`` and ``g``
are a rank's columns: the momentum is drawn for those columns alone,
the slab holds them, and every sum over D (energies, U-turn dots, the
target's) is the dim group's, so every per-chain flag, scalar and draw
is the same on each rank of the group.
"""

from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..ops.hamiltonian import hamiltonian, refresh_momentum, uturn
from ..ops.integrators import IntegratorConfig, get_integrator
from ..parallel.mesh import col_window, current_dim_split
from ..utils import threefry
from ..utils.constants import LOG_ZERO, WT_SUM_THRESH
from ..utils.p2 import P2State, p2_push
from .plans import build_schedule

_BIG_I32 = 2 ** 30


class WalnutsConfig(NamedTuple):
    """Static sampler configuration (keyword surface of
    ``WALNUTSpy/WALNUTS.py:111-129``)."""

    m: int = 10
    integrator: str = "adapt_leapfrog_r2p"
    igr: IntegratorConfig = IntegratorConfig()
    step_size_rand_scale: float = 0.2
    record_orbit_stats: bool = False
    use_inv_mass: bool = False  # identity metric by default (WALNUTSpy)


class TransitionResult(NamedTuple):
    q: torch.Tensor
    lp: torch.Tensor
    g: torch.Tensor
    diagnostics: torch.Tensor  # [C, 24]
    p2: P2State
    orbit_min: torch.Tensor    # [C, dg] ([C, 0] when disabled)
    orbit_max: torch.Tensor


def _mmin(cur, new, mask):
    return torch.where(mask, torch.minimum(cur, new), cur)


def _mmax(cur, new, mask):
    return torch.where(mask, torch.maximum(cur, new), cur)


def _draws(key, C, D, T, dtype, cfg, im, chain_block=None):
    """Every draw of one transition, in one batched pass per kind; with
    ``chain_block = (c0, C_total)``, rows ``c0 .. c0+C-1`` of the draws
    of ``C_total`` chains (every draw's leading axis is the chains');
    inside a dim split, the momentum's columns are the rank's (``D`` is
    the local width, ``im`` the whole diagonal)."""
    Cg, rows = C, None
    if chain_block is not None:
        c0, Cg = chain_block
        rows = (c0, c0 + C)
    Dg, cols = col_window(D)
    k_mom, k_dirs, k_orbit = threefry.split(key, 3)
    v0 = refresh_momentum(k_mom, (Cg, Dg), im, dtype, rows, cols)
    xi_all = torch.where(threefry.bernoulli(k_dirs, 0.5, (Cg, cfg.m),
                                            rows=rows),
                         1.0, -1.0).to(dtype)
    steps = torch.arange(T, dtype=torch.int64, device=key.device)
    sub = threefry.split(threefry.fold_in(k_orbit, steps), 6)  # [T, 6, 2]
    s = cfg.step_size_rand_scale
    jitter = threefry.uniform(sub[:, 0], (Cg, 2), dtype, 1.0 - s, 1.0 + s,
                              rows)
    if cfg.integrator == "adapt_leapfrog_r2p":
        coins = [threefry.uniform(sub[:, j], (Cg,), torch.float64,
                                  rows=rows) for j in (1, 2)]
    else:  # the other integrators draw nothing
        coins = [[None] * T] * 2
    u_cat = [threefry.uniform(sub[:, j], (Cg,), dtype, rows=rows)
             for j in (3, 4)]
    u_acc = threefry.uniform(sub[:, 5], (Cg,), dtype, rows=rows)
    return v0, xi_all, jitter, coins, u_cat, u_acc


def walnuts_transition(key, q, lp, g, h_step, delta, p2: P2State, warmup,
                       *, target, cfg: WalnutsConfig, inv_mass=None,
                       chain_block=None):
    """One WALNUTS transition for a ``[C, D]`` chain batch, on the device
    of its input tensors (``key``, ``q``, ...): unlike the public entries
    it takes no ``device=`` and does not default to the card.

    Args:
        key: threefry key of this iteration (``[2]`` int64 words).
        q, lp, g: current positions with cached density and gradient.
        h_step: per-chain macro step size ``H``, ``[C]``.
        delta: per-chain integrator tolerance, ``[C]``.
        p2: per-chain P2 estimators of the log step-size constant,
            pushed once per computed macro step during warmup.
        warmup: host bool, whether warmup statistics are collected.
        target, cfg: the target and the static configuration.
        inv_mass: optional diagonal inverse mass ``[D]`` (used when
            ``cfg.use_inv_mass``; the whole diagonal under a dim split).
        chain_block: ``(c0, C_total)`` when ``q`` holds chains ``c0 ..
            c0+C-1`` of a batch of ``C_total`` split over ranks: the
            draws are those chains' rows of the whole batch's draws.
    """
    C, D = q.shape
    dtype, dev = q.dtype, q.device
    sched = build_schedule(cfg.m)
    integrator = get_integrator(cfg.integrator)
    im = inv_mass if cfg.use_inv_mass else None
    T, S = sched.n_steps, sched.capacity

    v0, xi_all, jitter, coins, u_cat, u_acc = _draws(
        key, C, D, T, dtype, cfg, im, chain_block)
    ds = current_dim_split()
    if im is not None and ds is not None:
        im = im[..., ds.d0:ds.d1]       # the ops take the rank's columns
    hloc_all = h_step[None, :, None] * jitter                 # [T, C, 2]
    h0 = hamiltonian(lp, v0, im)

    gen0 = (target.generated(q) if cfg.record_orbit_stats
            else torch.zeros((C, 0), dtype=dtype, device=dev))
    zf = torch.zeros((C,), dtype=dtype, device=dev)
    zi = torch.zeros((C,), dtype=torch.int32, device=dev)
    zb = torch.zeros((C,), dtype=torch.bool, device=dev)

    def fi(v):
        return torch.full((C,), v, dtype=torch.int32, device=dev)

    c = SimpleNamespace(
        qp=q, vp=v0, gp=g, lpp=lp, hp=h0,
        qm=q, vm=v0, gm=g, lpm=lp, hm=h0,
        q_prop=q, lp_prop=lp, g_prop=g,
        q_prop_last=q, lp_prop_last=lp, g_prop_last=g,
        mscale=h0, lwt_sum_f=zf, lwt_sum_b=zf,
        w_new_sum=zf, w_old_sum=torch.ones_like(zf),
        sel_l=zi, sel_l_old=zi,
        idx_time=zf, index_stat=zf, index_stat_old=zf,
        time_f=zf, time_b=zf, orbit_len=zf, orbit_len_sam=zf,
        a_abs=zi, b_abs=zi,
        done=zb, depth_done=zb, stop_code=zi, both_ends_passive=zb,
        n_doubl_sampled=zi, n_doubl_computed=zi, max_f_int=zi, max_b_int=zi,
        neval_f=zi, neval_b=zi, h_min=h0, h_max=h0,
        if_min=fi(_BIG_I32), if_max=fi(-_BIG_I32),
        c_min=fi(_BIG_I32), c_max=fi(-_BIG_I32),
        lwt_min=torch.full_like(zf, torch.inf),
        lwt_max=torch.full_like(zf, -torch.inf),
        n_states=zi, n_if_neq_ib=zi, n_if_zero=zi,
        p2=p2,
        slab_q=torch.zeros((C, S, D), dtype=dtype, device=dev),
        slab_v=torch.zeros((C, S, D), dtype=dtype, device=dev),
        orbit_min=gen0, orbit_max=gen0,
    )

    thresh = torch.tensor(WT_SUM_THRESH, dtype=dtype, device=dev)
    log_zero_edge = LOG_ZERO + 1.0
    W = torch.where

    def integrate_once(coin, u, hloc, xi, fwd, rel, slot, active, is_d0):
        """One macro step from each chain's active end, with all
        bookkeeping.  Returns ``(q_new, v_new), finite, ok``."""
        f1 = fwd[:, None]
        res = integrator(coin, target, W(f1, c.qp, c.qm), W(f1, c.vp, c.vm),
                         W(f1, c.gp, c.gm), W(fwd, c.lpp, c.lpm),
                         W(fwd, c.hp, c.hm), hloc, xi, delta, im, active,
                         cfg.igr)
        finite = torch.isfinite(res.h_end)
        ok = active & finite

        af, ab = active & fwd, active & ~fwd
        af1, ab1 = af[:, None], ab[:, None]
        c.qp, c.vp, c.gp = (W(af1, res.q, c.qp), W(af1, res.v, c.vp),
                            W(af1, res.g, c.gp))
        c.lpp, c.hp = W(af, res.lp, c.lpp), W(af, res.h_end, c.hp)
        c.qm, c.vm, c.gm = (W(ab1, res.q, c.qm), W(ab1, res.v, c.vm),
                            W(ab1, res.g, c.gm))
        c.lpm, c.hm = W(ab, res.lp, c.lpm), W(ab, res.h_end, c.hm)

        abs_id = W(fwd, c.b_abs + rel, c.a_abs - rel)

        # aggregates recorded before the finiteness cut, matching the
        # reference's Hs/Ifs/cs/lwts array writes (WALNUTS.py:400-417)
        c.neval_f = c.neval_f + W(active, res.n_eval_f, 0)
        c.neval_b = c.neval_b + W(active, res.n_eval_b, 0)
        c.h_min = _mmin(c.h_min, res.h_end, active)
        c.h_max = _mmax(c.h_max, res.h_end, active)
        c.if_min = _mmin(c.if_min, res.i_f, active)
        c.if_max = _mmax(c.if_max, res.i_f, active)
        c.c_min = _mmin(c.c_min, res.c, active)
        c.c_max = _mmax(c.c_max, res.c, active)
        c.lwt_min = _mmin(c.lwt_min, res.lwt, active)
        c.lwt_max = _mmax(c.lwt_max, res.lwt, active)
        c.n_states = c.n_states + active.to(torch.int32)
        c.n_if_neq_ib = c.n_if_neq_ib + (
            active & (res.i_f != res.i_b)).to(torch.int32)
        c.n_if_zero = c.n_if_zero + (active & (res.i_f == 0)).to(torch.int32)
        c.max_f_int = W(af, abs_id, c.max_f_int)
        c.max_b_int = W(ab, abs_id, c.max_b_int)
        c.time_f = c.time_f + W(af, hloc, 0.0)
        c.time_b = c.time_b + W(ab, hloc, 0.0)
        if warmup:
            c.p2 = p2_push(c.p2, torch.log(res.igr_const), mask=active)

        # weight bookkeeping; the reference accumulates only finite
        # states (the non-finite break precedes lwtSum, WALNUTS.py:414-420)
        c.lwt_sum_f = c.lwt_sum_f + W(ok & fwd, res.lwt, 0.0)
        c.lwt_sum_b = c.lwt_sum_b + W(ok & ~fwd, res.lwt, 0.0)
        lwt_dir = W(fwd, c.lwt_sum_f, c.lwt_sum_b)
        w_new = torch.exp(-res.h_end + c.mscale + lwt_dir)
        c.w_new_sum = c.w_new_sum + W(ok, w_new, 0.0)

        # online categorical selection (WALNUTS.py:422-429); at depth 0
        # the proposal is replaced unconditionally (WALNUTS.py:326-329)
        if is_d0:
            sel = ok
        else:
            sel = ok & (c.w_new_sum > thresh) & (u * c.w_new_sum < w_new)
        signed_time = W(fwd, c.time_f, -c.time_b)
        # depth-0 orbit length counts the jittered step even when the
        # new Hamiltonian is non-finite (WALNUTS.py:298-300)
        olen_mask = active if is_d0 else ok

        sel1 = sel[:, None]
        c.q_prop = W(sel1, res.q, c.q_prop)
        c.lp_prop = W(sel, res.lp, c.lp_prop)
        c.g_prop = W(sel1, res.g, c.g_prop)
        c.sel_l = W(sel, abs_id, c.sel_l)
        c.idx_time = W(sel, signed_time, c.idx_time)
        c.orbit_len = c.orbit_len + W(olen_mask, hloc, 0.0)

        # checkpoint the new state for future merge checks (in place:
        # the slab is this call's own and no other name refers to it)
        ok1 = ok[:, None]
        c.slab_q[:, slot] = W(ok1, res.q, c.slab_q[:, slot])
        c.slab_v[:, slot] = W(ok1, res.v, c.slab_v[:, slot])

        if cfg.record_orbit_stats:
            gen = target.generated(res.q)
            c.orbit_min = W(ok1, torch.minimum(c.orbit_min, gen), c.orbit_min)
            c.orbit_max = W(ok1, torch.maximum(c.orbit_max, gen), c.orbit_max)
        return (res.q, res.v), finite, ok

    t = 0
    while t < T and bool((~c.done).any()):
        depth_t = int(sched.depth[t])
        is_d0 = bool(sched.is_depth0[t])
        first = t == 0 or depth_t != int(sched.depth[t - 1])
        xi = xi_all[:, depth_t]
        fwd = xi > 0
        f1 = fwd[:, None]
        hloc = hloc_all[t]

        # ---- depth-start snapshot (reference WALNUTS.py:291-295) ----
        if first:
            snap = ~c.done
            s1 = snap[:, None]
            c.q_prop_last = W(s1, c.q_prop, c.q_prop_last)
            c.lp_prop_last = W(snap, c.lp_prop, c.lp_prop_last)
            c.g_prop_last = W(s1, c.g_prop, c.g_prop_last)
            c.sel_l_old = W(snap, c.sel_l, c.sel_l_old)
            c.index_stat_old = W(snap, c.index_stat, c.index_stat_old)
            c.w_new_sum = W(snap, 0.0, c.w_new_sum)

        alive = ~c.done & ~c.depth_done

        # ---- first macro step of the pair ----
        (q1, v1), finite1, ok1 = integrate_once(
            coins[0][t], u_cat[0][t], hloc[:, 0], xi, fwd,
            int(sched.rel1[t]), int(sched.slot1[t]), alive, is_d0)
        forced = alive & ~finite1

        # ---- second macro step, U-turn and merge checks (pairs only;
        # at depth 0 no chain is active in them, so they change nothing)
        if not is_d0:
            act2 = ok1
            (q2, v2), finite2, ok2 = integrate_once(
                coins[1][t], u_cat[1][t], hloc[:, 1], xi, fwd,
                int(sched.rel2[t]), int(sched.slot2[t]), act2, False)
            forced = forced | (act2 & ~finite2)

            # temporally earlier state: rel1 forward, rel2 backward
            adj_ut = uturn(W(f1, q1, q2), W(f1, v1, v2), W(f1, q2, q1),
                           W(f1, v2, v1), im)
            depth_done = c.depth_done | (ok2 & adj_ut)

            # merge checks against slab checkpoints (WALNUTS.py:572-587)
            for kk in range(sched.max_post):
                if not sched.post_valid[t, kk]:
                    continue
                slo = int(sched.post_slot_lo[t, kk])
                shi = int(sched.post_slot_hi[t, kk])
                q_lo, v_lo = c.slab_q[:, slo], c.slab_v[:, slo]
                q_hi, v_hi = c.slab_q[:, shi], c.slab_v[:, shi]
                m_ut = uturn(W(f1, q_lo, q_hi), W(f1, v_lo, v_hi),
                             W(f1, q_hi, q_lo), W(f1, v_hi, v_lo), im)
                depth_done = depth_done | (ok2 & m_ut)
            c.depth_done = depth_done

        # ---- numerical problems: forced rejection, stop code 999 ----
        c.stop_code = W(forced, 999, c.stop_code)
        c.done = c.done | forced

        # ---- depth-end resolution (a no-op on other steps) ----
        if sched.last_of_depth[t]:
            p_mask = ~c.done
            su = p_mask & c.depth_done          # sub-U-turn: rejected
            go = p_mask & ~c.depth_done

            keep_new = u_acc[t] * c.w_old_sum < c.w_new_sum
            restore = su | (go & ~keep_new)
            r1 = restore[:, None]
            c.q_prop = W(r1, c.q_prop_last, c.q_prop)
            c.lp_prop = W(restore, c.lp_prop_last, c.lp_prop)
            c.g_prop = W(r1, c.g_prop_last, c.g_prop)
            c.sel_l = W(restore, c.sel_l_old, c.sel_l)
            c.index_stat = W(restore, c.index_stat_old,
                             W(p_mask, c.idx_time / (c.time_f + c.time_b),
                               c.index_stat))

            # sub-U-turn bookkeeping (WALNUTS.py:597-605)
            c.n_doubl_sampled = W(su, depth_t, c.n_doubl_sampled)
            c.n_doubl_computed = W(su, depth_t + 1, c.n_doubl_computed)
            c.stop_code = W(su, 5, c.stop_code)
            c.done = c.done | su

            # joined-orbit U-turn / dead ends (WALNUTS.py:620-634)
            joined = uturn(c.qm, c.vm, c.qp, c.vp, im)
            passive = ((c.lwt_sum_b < log_zero_edge)
                       & (c.lwt_sum_f < log_zero_edge))
            stop_now = go & (joined | passive)
            c.n_doubl_sampled = W(go, depth_t + 1, c.n_doubl_sampled)
            c.n_doubl_computed = W(go, depth_t + 1, c.n_doubl_computed)
            c.orbit_len_sam = W(go, c.orbit_len, c.orbit_len_sam)
            c.both_ends_passive = W(go, passive, c.both_ends_passive)
            c.stop_code = W(stop_now, W(joined, 4, -4).to(torch.int32),
                            c.stop_code)
            c.done = c.done | stop_now

            # a new doubling will be attempted (WALNUTS.py:640-648)
            cont = go & ~stop_now
            pw = 1 << depth_t
            c.w_old_sum = W(cont, c.w_old_sum + c.w_new_sum, c.w_old_sum)
            c.b_abs = W(cont & fwd, c.b_abs + pw, c.b_abs)
            c.a_abs = W(cont & ~fwd, c.a_abs - pw, c.a_abs)
            c.depth_done = zb
        t += 1

    # ------------------------------------------------------------------
    # 24-column diagnostics row (contract of WALNUTS.py:670-693)
    either_passive = ((c.lwt_sum_b < log_zero_edge)
                      | (c.lwt_sum_f < log_zero_edge))
    nst = torch.clamp(c.n_states, min=1).to(dtype)
    cols = [
        c.sel_l, c.n_doubl_sampled, c.orbit_len, c.orbit_len_sam,
        c.max_f_int, c.max_b_int, c.neval_f, c.neval_b, c.if_min, c.if_max,
        c.lwt_min, c.lwt_max, c.both_ends_passive, either_passive,
        c.n_if_neq_ib.to(dtype) / nst, h_step, c.n_if_zero.to(dtype) / nst,
        c.h_max - c.h_min, delta, c.stop_code, c.n_doubl_computed,
        c.c_min, c.c_max, c.index_stat,
    ]
    diag = torch.stack([x.to(dtype) for x in cols], dim=-1)
    return TransitionResult(q=c.q_prop, lp=c.lp_prop, g=c.g_prop,
                            diagnostics=diag, p2=c.p2,
                            orbit_min=c.orbit_min, orbit_max=c.orbit_max)
