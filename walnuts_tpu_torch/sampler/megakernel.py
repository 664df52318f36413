"""Fully flattened WALNUTS engine: one leapfrog micro step per chain per
round (``walnuts_tpu/sampler/megakernel.py``).

Each chain carries a small state machine (phase, refinement level,
micro-step index) for its current integrator trial, and every round
advances every chain by up to ``micro_unroll`` micro steps.  A chain
that finishes a trial starts the next one at once; a chain that
finishes a macro step does the orbit bookkeeping in the same round.
No chain waits for another.

This module holds the engine's state (:class:`MState`, the JAX
``_MState`` field for field), the counter-hash draws, the plain torch
round body (sections A-G of the JAX round body), the ring flush, the
pooled warmup consensus and the public entry :func:`run_walnuts_fused`.
Rounds run sixteen at a time, one flush period per call of
:func:`..round_kernel.run_rounds`: the hand-written CUDA kernel on the
card (one launch, or for a target without a fused gradient one launch
per stretch between two gradient points, with the target's torch
gradient between them), the plain round body here on the CPU.

Randomness is the JAX engine's ``rng="hash"`` stream: every draw is a
splitmix32 hash of (seed, global chain id, absolute round, purpose),
so a chain's trajectory depends only on its own id, and the port
replays the JAX engine's uniforms and direction bits bitwise.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.hamiltonian import hamiltonian, uturn
from ..parallel.mesh import (FUSED_DIM_SPLIT_ITEM, chain_block, chains_only,
                             gather_rows, reduce_int, split)
from ..utils.constants import LOG_ZERO, WT_SUM_THRESH
from ..utils.device import DEFAULT_DEVICE, resolve_device, to_device
from ..utils import threefry, trace
from ..utils.p2 import P2State, p2_init, p2_push, p2_quantile
from .driver import WarmupConfig
from .transition import WalnutsConfig

_BIG_I32 = 2 ** 30
FWD, R2P, BWD = 0, 1, 2
FLUSH_EVERY = 16  # rounds between ring flushes: one kernel launch
STOP_MODES = ("per_chain", "total", "min_per_chain")
INTEGRATORS = ("adapt_leapfrog_r2p", "adapt_leapfrog_d", "fixed_leapfrog")


def slab_dtype(dtype):
    """Span-slab storage dtype: bf16 under float32 runs, the run dtype
    otherwise (``megakernel.py:75-78``)."""
    return torch.bfloat16 if dtype == torch.float32 else dtype


class MState(NamedTuple):
    """Engine state, field for field the JAX ``_MState``.  ``n`` (the
    absolute round) is a Python int; ``xi_bits`` holds uint32 values in
    int64; the other integer fields are int32."""
    n: int
    t: torch.Tensor
    it: torch.Tensor
    phase: torch.Tensor
    c_cur: torch.Tensor
    k: torch.Tensor
    second: torch.Tensor
    h_loc: torch.Tensor
    coarse: torch.Tensor
    i_f: torch.Tensor
    qs: torch.Tensor
    vs: torch.Tensor
    gs: torch.Tensor
    lps: torch.Tensor
    h0s: torch.Tensor
    qt: torch.Tensor
    vt: torch.Tensor
    gt: torch.Tensor
    lpt: torch.Tensor
    ht: torch.Tensor
    dht: torch.Tensor
    fint: torch.Tensor
    qa: torch.Tensor
    va: torch.Tensor
    ga: torch.Tensor
    lpa: torch.Tensor
    ha: torch.Tensor
    dha: torch.Tensor
    c_sim: torch.Tensor
    nev_f: torch.Tensor
    nev_b: torch.Tensor
    q1: torch.Tensor
    v1: torch.Tensor
    qp: torch.Tensor
    vp: torch.Tensor
    gp: torch.Tensor
    lpp: torch.Tensor
    hp: torch.Tensor
    qm: torch.Tensor
    vm: torch.Tensor
    gm: torch.Tensor
    lpm: torch.Tensor
    hm: torch.Tensor
    qc: torch.Tensor
    lpc: torch.Tensor
    gc: torch.Tensor
    q_prop: torch.Tensor
    lp_prop: torch.Tensor
    g_prop: torch.Tensor
    q_prop_last: torch.Tensor
    lp_prop_last: torch.Tensor
    g_prop_last: torch.Tensor
    mscale: torch.Tensor
    lwt_sum_f: torch.Tensor
    lwt_sum_b: torch.Tensor
    w_new_sum: torch.Tensor
    w_old_sum: torch.Tensor
    sel_l: torch.Tensor
    sel_l_old: torch.Tensor
    idx_time: torch.Tensor
    index_stat: torch.Tensor
    index_stat_old: torch.Tensor
    time_f: torch.Tensor
    time_b: torch.Tensor
    orbit_len: torch.Tensor
    orbit_len_sam: torch.Tensor
    a_abs: torch.Tensor
    b_abs: torch.Tensor
    xi_bits: torch.Tensor
    depth_done: torch.Tensor
    stop_code: torch.Tensor
    both_ends_passive: torch.Tensor
    n_doubl_sampled: torch.Tensor
    n_doubl_computed: torch.Tensor
    max_f_int: torch.Tensor
    max_b_int: torch.Tensor
    neval_f: torch.Tensor
    neval_b: torch.Tensor
    h_min: torch.Tensor
    h_max: torch.Tensor
    if_min: torch.Tensor
    if_max: torch.Tensor
    c_min_d: torch.Tensor
    c_max_d: torch.Tensor
    lwt_min: torch.Tensor
    lwt_max: torch.Tensor
    n_states: torch.Tensor
    n_if_neq_ib: torch.Tensor
    n_if_zero: torch.Tensor
    slab_q: torch.Tensor
    slab_v: torch.Tensor
    samples: torch.Tensor
    diags: torch.Tensor
    grad_ct: torch.Tensor
    pend0: torch.Tensor
    pend1: torch.Tensor
    prow0: torch.Tensor
    prow1: torch.Tensor
    pgen0: torch.Tensor
    pgen1: torch.Tensor
    pdiag0: torch.Tensor      # [24, C] (row-contiguous, as in JAX)
    pdiag1: torch.Tensor
    h_cur: torch.Tensor
    delta_cur: torch.Tensor
    p2h: P2State
    p2d: P2State


# ---------------------------------------------------------------------------
# per-chain counter-hash RNG (megakernel.py:223-296), in int64 with masking
# ---------------------------------------------------------------------------

HASH_M1 = 0x9E3779B9
HASH_M2 = 0x85EBCA6B
HASH_M3 = 0xC2B2AE35
_M32 = 0xFFFFFFFF
_U_SC = 2.0 ** -24
_U_OFF = 2.0 ** -25
_TWO_PI = 6.283185307179586


def _mul32(x, c):
    """``x * c mod 2^32`` for uint32 values held in int64, split in
    16-bit halves so that no product leaves int64's range."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """splitmix32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def make_hash_draw(seed, cid, D, dtype):
    """Build ``draw(n_abs) -> rnd``: the six per-round draws keyed by
    (``seed``, global chain id ``cid`` [C] int64, absolute round,
    purpose[, coordinate]).  ``seed`` is the JAX engine's int32 hash
    seed.  Uniforms come from the top 24 bits, so they are exact."""
    dev = cid.device
    h_c = _mix32(((int(seed) & _M32) + _mul32(cid, HASH_M1)) & _M32)
    lane_m1 = _mul32(torch.arange(D, dtype=torch.int64, device=dev),
                     HASH_M1)

    def to_f(x):
        return (x >> 8).to(dtype)

    def draw(n_abs):
        h_r = _mix32((h_c + ((int(n_abs) * HASH_M2) & _M32)) & _M32)

        def bits(p):
            return _mix32((h_r + ((p * HASH_M3) & _M32)) & _M32)

        def u(p):
            return to_f(bits(p)) * _U_SC

        b1 = _mix32((h_r[:, None] + ((5 * HASH_M3) & _M32) + lane_m1)
                    & _M32)
        b2 = _mix32((h_r[:, None] + ((6 * HASH_M3) & _M32) + lane_m1)
                    & _M32)
        u1 = to_f(b1) * _U_SC + _U_OFF
        u2 = to_f(b2) * _U_SC
        mom = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
        return dict(h_u=u(0), co_u=u(1), cat_u=u(2), acc_u=u(3),
                    dirs=bits(4), mom=mom)

    return draw


# ---------------------------------------------------------------------------
# plain round body
# ---------------------------------------------------------------------------

def _depth(t, m):
    """``32 - clz(t)`` for ``0 <= t < 2^m``, exactly: ``#{j : t >= 2^j}``."""
    d = torch.zeros_like(t)
    for j in range(m):
        d = d + (t >= (1 << j)).to(t.dtype)
    return d


def protocol(cfg: WalnutsConfig):
    """``(proto_d, min_c, max_c)`` of the integrator protocol: the D
    protocol is R2P with the coarse draw forced; fixed leapfrog is the
    D protocol at ``min_c == max_c == 0``."""
    proto_d = cfg.integrator in ("adapt_leapfrog_d", "fixed_leapfrog")
    if cfg.integrator == "fixed_leapfrog":
        return proto_d, 0, 0
    return proto_d, cfg.igr.min_c, cfg.igr.max_c


def dtype_consts(cfg: WalnutsConfig, dtype):
    """Constants computed in the run dtype, as the JAX body computes
    them with numpy: ``(lp_c, lp_f, thresh)``."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    p0 = cfg.igr.r2p_prob0
    return (float(np.log(np.asarray(p0, np_dtype))),
            float(np.log(np.asarray(1.0 - p0, np_dtype))),
            float(np.asarray(WT_SUM_THRESH, np_dtype)))


def make_round_body(*, target, cfg, warmup, stop_mode, num_iter,
                    micro_unroll=1):
    """Build the plain one-round transition ``body(st, rnd) -> st``
    (``megakernel.py:320-1019``): masked elementwise torch over ``[C]``
    and ``[C, D]`` state."""
    m = cfg.m
    proto_d, min_c, max_c = protocol(cfg)
    p0 = cfg.igr.r2p_prob0
    T = 2 ** (m - 1)
    S = max(m - 2, 1)
    log_zero_edge = LOG_ZERO + 1.0

    def body(st, rnd):
        dtype = st.qc.dtype
        dev = st.qc.device
        lp_c, lp_f, thresh = (torch.tensor(v, dtype=dtype, device=dev)
                              for v in dtype_consts(cfg, dtype))
        C = st.t.shape[0]
        W = torch.where

        def col(x):
            return x[:, None]

        if stop_mode in ("total", "min_per_chain"):
            live = torch.ones((C,), dtype=torch.bool, device=dev)
        else:
            live = st.it < num_iter

        # A. fresh-transition init (a chain with both pending slots
        #    occupied stalls until the next flush)
        needs_fresh = (st.k < 0) & (st.t == 0)
        stall = st.pend0 & st.pend1
        if stop_mode == "min_per_chain":
            stall = stall & (st.it < num_iter)
        fresh = live & needs_fresh & ~stall
        v0 = rnd["mom"]
        h0f = hamiltonian(st.lpc, v0)
        f1 = col(fresh)
        st = st._replace(
            qp=W(f1, st.qc, st.qp), vp=W(f1, v0, st.vp),
            gp=W(f1, st.gc, st.gp), lpp=W(fresh, st.lpc, st.lpp),
            hp=W(fresh, h0f, st.hp),
            qm=W(f1, st.qc, st.qm), vm=W(f1, v0, st.vm),
            gm=W(f1, st.gc, st.gm), lpm=W(fresh, st.lpc, st.lpm),
            hm=W(fresh, h0f, st.hm),
            q_prop=W(f1, st.qc, st.q_prop),
            lp_prop=W(fresh, st.lpc, st.lp_prop),
            g_prop=W(f1, st.gc, st.g_prop),
            q_prop_last=W(f1, st.qc, st.q_prop_last),
            lp_prop_last=W(fresh, st.lpc, st.lp_prop_last),
            g_prop_last=W(f1, st.gc, st.g_prop_last),
            mscale=W(fresh, h0f, st.mscale),
            lwt_sum_f=W(fresh, 0.0, st.lwt_sum_f),
            lwt_sum_b=W(fresh, 0.0, st.lwt_sum_b),
            w_new_sum=W(fresh, 0.0, st.w_new_sum),
            w_old_sum=W(fresh, 1.0, st.w_old_sum),
            sel_l=W(fresh, 0, st.sel_l),
            sel_l_old=W(fresh, 0, st.sel_l_old),
            idx_time=W(fresh, 0.0, st.idx_time),
            index_stat=W(fresh, 0.0, st.index_stat),
            index_stat_old=W(fresh, 0.0, st.index_stat_old),
            time_f=W(fresh, 0.0, st.time_f),
            time_b=W(fresh, 0.0, st.time_b),
            orbit_len=W(fresh, 0.0, st.orbit_len),
            orbit_len_sam=W(fresh, 0.0, st.orbit_len_sam),
            a_abs=W(fresh, 0, st.a_abs), b_abs=W(fresh, 0, st.b_abs),
            xi_bits=W(fresh, rnd["dirs"], st.xi_bits),
            depth_done=st.depth_done & ~fresh,
            stop_code=W(fresh, 0, st.stop_code),
            both_ends_passive=st.both_ends_passive & ~fresh,
            n_doubl_sampled=W(fresh, 0, st.n_doubl_sampled),
            n_doubl_computed=W(fresh, 0, st.n_doubl_computed),
            max_f_int=W(fresh, 0, st.max_f_int),
            max_b_int=W(fresh, 0, st.max_b_int),
            neval_f=W(fresh, 0, st.neval_f),
            neval_b=W(fresh, 0, st.neval_b),
            h_min=W(fresh, h0f, st.h_min), h_max=W(fresh, h0f, st.h_max),
            if_min=W(fresh, _BIG_I32, st.if_min),
            if_max=W(fresh, -_BIG_I32, st.if_max),
            c_min_d=W(fresh, _BIG_I32, st.c_min_d),
            c_max_d=W(fresh, -_BIG_I32, st.c_max_d),
            lwt_min=W(fresh, float("inf"), st.lwt_min),
            lwt_max=W(fresh, float("-inf"), st.lwt_max),
            n_states=W(fresh, 0, st.n_states),
            n_if_neq_ib=W(fresh, 0, st.n_if_neq_ib),
            n_if_zero=W(fresh, 0, st.n_if_zero),
            second=st.second & ~fresh,
        )

        # per-chain schedule row in closed form: depth d occupies rows
        # [2^(d-1), 2^d); pair j of a depth integrates states 2j+1, 2j+2
        t = st.t
        depth_t = _depth(t, m)
        is_d0 = t == 0
        one = torch.ones_like(t)
        pw_d = one << depth_t
        last = t == pw_d - 1
        first = (t & (t - 1)) == 0
        j_pair = t - (one << torch.clamp(depth_t - 1, min=0))
        rel1_t = W(is_d0, 1, 2 * j_pair + 1)
        rel2_t = W(is_d0, 0, 2 * j_pair + 2)
        fwd_dir = ((st.xi_bits >> depth_t.to(torch.int64)) & 1) == 1
        fw1 = col(fwd_dir)

        # depth-start snapshot (once, on the row's first macro start)
        snap = (live & first & ~is_d0 & (st.k < 0) & ~st.second
                & ~st.depth_done)
        st = st._replace(
            q_prop_last=W(col(snap), st.q_prop, st.q_prop_last),
            lp_prop_last=W(snap, st.lp_prop, st.lp_prop_last),
            g_prop_last=W(col(snap), st.g_prop, st.g_prop_last),
            sel_l_old=W(snap, st.sel_l, st.sel_l_old),
            index_stat_old=W(snap, st.index_stat, st.index_stat_old),
            w_new_sum=W(snap, 0.0, st.w_new_sum),
        )

        # B. macro-step start: latch a jittered step, the coarse draw
        #    and the trial start state
        idle = st.depth_done
        starting = live & (st.k < 0) & ~idle & ~(needs_fresh & stall)
        s_sc = cfg.step_size_rand_scale
        h_draw = st.h_cur * ((1.0 - s_sc) + rnd["h_u"] * (2.0 * s_sc))
        co_draw = (torch.ones((C,), dtype=torch.bool, device=dev)
                   if proto_d else rnd["co_u"] < p0)
        q_e = W(fw1, st.qp, st.qm)
        v_e = W(fw1, st.vp, -st.vm)
        g_e = W(fw1, st.gp, st.gm)
        lp_e = W(fwd_dir, st.lpp, st.lpm)
        h_e = W(fwd_dir, st.hp, st.hm)
        s1c = col(starting)
        st = st._replace(
            h_loc=W(starting, h_draw, st.h_loc),
            coarse=W(starting, co_draw, st.coarse),
            phase=W(starting, FWD, st.phase),
            c_cur=W(starting, min_c, st.c_cur),
            k=W(starting, 0, st.k),
            qs=W(s1c, q_e, st.qs), vs=W(s1c, v_e, st.vs),
            gs=W(s1c, g_e, st.gs),
            lps=W(starting, lp_e, st.lps), h0s=W(starting, h_e, st.h0s),
            qt=W(s1c, q_e, st.qt), vt=W(s1c, v_e, st.vt),
            gt=W(s1c, g_e, st.gt),
            lpt=W(starting, lp_e, st.lpt), ht=W(starting, h_e, st.ht),
            dht=W(starting, 0.0, st.dht), fint=W(starting, 1.0, st.fint),
            nev_f=W(starting, 0, st.nev_f), nev_b=W(starting, 0, st.nev_b),
            i_f=W(starting, max_c, st.i_f),
        )

        # C. up to micro_unroll leapfrog micro steps per integrating chain
        n_steps_cur = one << st.c_cur
        base = live & (st.k >= 0) & ~idle
        for _sub in range(micro_unroll):
            integ = base & (st.k < n_steps_cur)
            hh1 = col(W(integ, st.h_loc / n_steps_cur.to(dtype), 0.0))
            vh = st.vt + 0.5 * hh1 * st.gt
            q2 = st.qt + hh1 * vh
            lp2, g2 = target.logp_grad(q2)
            v2 = vh + 0.5 * hh1 * g2
            h2 = -lp2 + 0.5 * torch.sum(v2 * v2, dim=-1)
            i1 = col(integ)
            dh2 = torch.abs(h2 - st.ht)
            st = st._replace(
                qt=W(i1, q2, st.qt), vt=W(i1, v2, st.vt),
                gt=W(i1, g2, st.gt),
                lpt=W(integ, lp2, st.lpt), ht=W(integ, h2, st.ht),
                dht=W(integ, torch.maximum(st.dht, dh2), st.dht),
                fint=W(integ & ~torch.isfinite(h2), 0.0, st.fint),
                k=W(integ, st.k + 1, st.k),
                nev_f=st.nev_f + (integ & (st.phase != BWD)).to(torch.int32),
                nev_b=st.nev_b + (integ & (st.phase == BWD)).to(torch.int32),
                grad_ct=st.grad_ct + integ.to(torch.int32),
            )

        # D. trial completion
        t_done = base & (st.k >= n_steps_cur)
        t_fin = st.fint > 0.5
        err_ok = t_fin & (torch.abs(st.h0s - st.ht) < st.delta_cur)

        f_done = t_done & (st.phase == FWD)
        f_acc = f_done & (err_ok | (st.c_cur == max_c))
        a1 = col(f_acc)
        st = st._replace(
            i_f=W(f_acc, st.c_cur, st.i_f),
            qa=W(a1, st.qt, st.qa), va=W(a1, st.vt, st.va),
            ga=W(a1, st.gt, st.ga),
            lpa=W(f_acc, st.lpt, st.lpa), ha=W(f_acc, st.ht, st.ha),
            dha=W(f_acc, st.dht, st.dha),
            c_sim=W(f_acc, st.c_cur, st.c_sim),
        )
        f_retry = f_done & ~f_acc
        go_fine = f_acc & ~st.coarse
        go_bwd_f = f_acc & st.coarse

        r_done = t_done & (st.phase == R2P)
        r1 = col(r_done)
        st = st._replace(
            qa=W(r1, st.qt, st.qa), va=W(r1, st.vt, st.va),
            ga=W(r1, st.gt, st.ga),
            lpa=W(r_done, st.lpt, st.lpa), ha=W(r_done, st.ht, st.ha),
            dha=W(r_done, st.dht, st.dha),
            c_sim=W(r_done, st.c_cur, st.c_sim),
        )

        b_done = t_done & (st.phase == BWD)
        b_err_ok = t_fin & (torch.abs(st.ha - st.ht) < st.delta_cur)
        max_try = W(st.coarse, st.i_f - 1, max_c)
        b_found = b_done & b_err_ok
        b_next = b_done & ~b_err_ok & (st.c_cur < max_try)
        b_exhaust = b_done & ~b_err_ok & (st.c_cur >= max_try)
        i_b = W(b_found, st.c_cur, W(st.coarse, st.i_f, max_c))

        def reset_trial(st, mask, q, v, g, lp, h0):
            mk = col(mask)
            return st._replace(
                qt=W(mk, q, st.qt), vt=W(mk, v, st.vt), gt=W(mk, g, st.gt),
                lpt=W(mask, lp, st.lpt), ht=W(mask, h0, st.ht),
                dht=W(mask, 0.0, st.dht), fint=W(mask, 1.0, st.fint),
                k=W(mask, 0, st.k))

        st = reset_trial(st, f_retry, st.qs, st.vs, st.gs, st.lps, st.h0s)
        st = st._replace(c_cur=W(f_retry, st.c_cur + 1, st.c_cur))
        st = reset_trial(st, go_fine, st.qs, st.vs, st.gs, st.lps, st.h0s)
        st = st._replace(phase=W(go_fine, R2P, st.phase),
                         c_cur=W(go_fine, st.i_f + 1, st.c_cur))
        to_bwd = go_bwd_f | r_done
        bwd_has_levels = W(st.coarse, st.i_f - 1, max_c) >= min_c
        start_bwd = to_bwd & bwd_has_levels
        st = reset_trial(st, start_bwd, st.qa, -st.va, st.ga, st.lpa,
                         st.ha)
        st = st._replace(phase=W(start_bwd, BWD, st.phase),
                         c_cur=W(start_bwd, min_c, st.c_cur))
        st = reset_trial(st, b_next, st.qa, -st.va, st.ga, st.lpa, st.ha)
        st = st._replace(c_cur=W(b_next, st.c_cur + 1, st.c_cur))

        # E. macro-step completion and orbit bookkeeping
        no_levels = to_bwd & ~bwd_has_levels
        md = no_levels | b_found | b_exhaust
        i_b = W(no_levels, W(st.coarse, st.i_f, max_c), i_b)
        finite_m = torch.isfinite(st.ha)
        ok = md & finite_m

        if proto_d:
            lwt = W(st.i_f == i_b, 0.0, LOG_ZERO).to(dtype)
        else:
            lwt_f_term = W(st.coarse, lp_c, lp_f)
            lwt_b_term = W(st.c_sim == i_b, lp_c,
                           W(st.c_sim == i_b + 1, lp_f, LOG_ZERO))
            lwt = (lwt_b_term - lwt_f_term).to(dtype)

        v_orb = W(fw1, st.va, -st.va)
        af = ok & fwd_dir
        ab = ok & ~fwd_dir
        rel = W(st.second, rel2_t, rel1_t)
        abs_id = W(fwd_dir, st.b_abs + rel, st.a_abs - rel)

        igr = ((st.h_loc / torch.exp2(st.c_sim.to(dtype)))
               * torch.clamp(st.dha, min=1e-30) ** (-1.0 / 3.0))

        lwt_sum_f = st.lwt_sum_f + W(af, lwt, 0.0)
        lwt_sum_b = st.lwt_sum_b + W(ab, lwt, 0.0)
        lwt_dir = W(fwd_dir, lwt_sum_f, lwt_sum_b)
        w_new = torch.exp(-st.ha + st.mscale + lwt_dir)
        w_new_sum = st.w_new_sum + W(ok, w_new, 0.0)
        sel = (ok & (w_new_sum > thresh)
               & (rnd["cat_u"] * w_new_sum < w_new) & ~is_d0)
        sel = sel | (ok & is_d0)
        time_f2 = st.time_f + W(af, st.h_loc, 0.0)
        time_b2 = st.time_b + W(ab, st.h_loc, 0.0)
        signed_time = W(fwd_dir, time_f2, -time_b2)
        olen_mask = W(is_d0, md, ok)

        # span levels j = 2..S+1: level j opens (store) at rel1 == 1
        # (mod 2^j) and closes (merge check) at rel2 == 0 (mod 2^j)
        jlev = torch.arange(2, S + 2, dtype=torch.int32, device=dev)[None]
        pw_lev = torch.ones_like(jlev) << jlev
        lev_ok = jlev <= col(depth_t)
        store_lvl = lev_ok & ((col(rel1_t) & (pw_lev - 1)) == 1)
        check_lvl = (lev_ok & ((col(rel2_t) & (pw_lev - 1)) == 0)
                     & (col(rel2_t) >= pw_lev))
        store_lvls = store_lvl & col(ok & ~st.second)
        sel1 = col(sel)
        st = st._replace(
            qp=W(col(af), st.qa, st.qp), vp=W(col(af), v_orb, st.vp),
            gp=W(col(af), st.ga, st.gp),
            lpp=W(af, st.lpa, st.lpp), hp=W(af, st.ha, st.hp),
            qm=W(col(ab), st.qa, st.qm), vm=W(col(ab), v_orb, st.vm),
            gm=W(col(ab), st.ga, st.gm),
            lpm=W(ab, st.lpa, st.lpm), hm=W(ab, st.ha, st.hm),
            neval_f=st.neval_f + W(md, st.nev_f, 0),
            neval_b=st.neval_b + W(md, st.nev_b, 0),
            h_min=W(md, torch.minimum(st.h_min, st.ha), st.h_min),
            h_max=W(md, torch.maximum(st.h_max, st.ha), st.h_max),
            if_min=W(md, torch.minimum(st.if_min, st.i_f), st.if_min),
            if_max=W(md, torch.maximum(st.if_max, st.i_f), st.if_max),
            c_min_d=W(md, torch.minimum(st.c_min_d, st.c_sim), st.c_min_d),
            c_max_d=W(md, torch.maximum(st.c_max_d, st.c_sim), st.c_max_d),
            lwt_min=W(md, torch.minimum(st.lwt_min, lwt), st.lwt_min),
            lwt_max=W(md, torch.maximum(st.lwt_max, lwt), st.lwt_max),
            n_states=st.n_states + md.to(torch.int32),
            n_if_neq_ib=st.n_if_neq_ib + (md & (st.i_f != i_b)).to(
                torch.int32),
            n_if_zero=st.n_if_zero + (md & (st.i_f == 0)).to(torch.int32),
            max_f_int=W(af, abs_id, st.max_f_int),
            max_b_int=W(ab, abs_id, st.max_b_int),
            time_f=time_f2, time_b=time_b2,
            lwt_sum_f=lwt_sum_f, lwt_sum_b=lwt_sum_b, w_new_sum=w_new_sum,
            q_prop=W(sel1, st.qa, st.q_prop),
            lp_prop=W(sel, st.lpa, st.lp_prop),
            g_prop=W(sel1, st.ga, st.g_prop),
            sel_l=W(sel, abs_id, st.sel_l),
            idx_time=W(sel, signed_time, st.idx_time),
            orbit_len=st.orbit_len + W(olen_mask, st.h_loc, 0.0),
        )
        sdt = st.slab_q.dtype
        sv = store_lvls[:, :, None]
        st = st._replace(
            slab_q=W(sv, st.qa[:, None, :].to(sdt), st.slab_q),
            slab_v=W(sv, v_orb[:, None, :].to(sdt), st.slab_v),
        )

        if warmup is not None and warmup.adapt_h:
            in_wu_m = st.it < warmup.warmup_iter
            st = st._replace(p2h=p2_push(
                st.p2h, torch.log(igr), mask=md & finite_m & in_wu_m))

        forced = md & ~finite_m

        # pair / row sequencing (row_done uses the pre-update pair flag)
        second_prev = st.second
        first_done = md & ~second_prev & ~is_d0 & finite_m
        fd1 = col(first_done)
        st = st._replace(
            q1=W(fd1, st.qa, st.q1), v1=W(fd1, v_orb, st.v1),
            second=st.second | first_done,
            k=W(first_done, -1, st.k),
        )
        row_done = (md & (second_prev | is_d0) & finite_m) | forced
        pair_ok = md & second_prev & finite_m

        ut = _pair_uturn(st, v_orb, fw1, check_lvl, dtype)
        st = st._replace(depth_done=st.depth_done | (pair_ok & ut),
                         stop_code=W(forced, 999, st.stop_code))

        done = forced
        jump = live & st.depth_done & ~last
        arrived = live & st.depth_done & last & (st.k < 0)
        p_mask = live & last & ((row_done & ~forced) | arrived)
        su = p_mask & st.depth_done
        go = p_mask & ~st.depth_done

        keep_new = rnd["acc_u"] * st.w_old_sum < st.w_new_sum
        restore = su | (go & ~keep_new)
        st = st._replace(
            q_prop=W(col(restore), st.q_prop_last, st.q_prop),
            lp_prop=W(restore, st.lp_prop_last, st.lp_prop),
            g_prop=W(col(restore), st.g_prop_last, st.g_prop),
            sel_l=W(restore, st.sel_l_old, st.sel_l),
            index_stat=W(restore, st.index_stat_old, W(
                p_mask, st.idx_time / torch.clamp(
                    st.time_f + st.time_b, min=1e-30),
                st.index_stat)),
            n_doubl_sampled=W(su, depth_t, st.n_doubl_sampled),
            n_doubl_computed=W(su, depth_t + 1, st.n_doubl_computed),
            stop_code=W(su, 5, st.stop_code),
        )
        done = done | su

        joined = uturn(st.qm, st.vm, st.qp, st.vp)
        passive = ((st.lwt_sum_b < log_zero_edge)
                   & (st.lwt_sum_f < log_zero_edge))
        stop_now = go & (joined | passive)
        st = st._replace(
            n_doubl_sampled=W(go, depth_t + 1, st.n_doubl_sampled),
            n_doubl_computed=W(go, depth_t + 1, st.n_doubl_computed),
            orbit_len_sam=W(go, st.orbit_len, st.orbit_len_sam),
            both_ends_passive=W(go, passive, st.both_ends_passive),
            stop_code=W(stop_now, W(joined, 4, -4).to(torch.int32),
                        st.stop_code),
        )
        done = done | stop_now

        cont = go & ~stop_now
        exhausted = cont & (st.t + 1 >= T)
        done = (done | exhausted) & live
        st = st._replace(
            w_old_sum=W(cont, st.w_old_sum + st.w_new_sum, st.w_old_sum),
            b_abs=W(cont & fwd_dir, st.b_abs + pw_d, st.b_abs),
            a_abs=W(cont & ~fwd_dir, st.a_abs - pw_d, st.a_abs),
            depth_done=st.depth_done & ~p_mask,
        )

        # F. stage completed transitions into a free pending slot; the
        #    slot records the absolute draw index
        store = done
        if stop_mode == "min_per_chain":
            store = done & (st.it < num_iter)
        st = _stage(st, store, target, dtype)

        # per-chain tuning at transition completion, after the
        # diagnostics row is latched
        if warmup is not None:
            adone = done & (st.it < warmup.warmup_iter)
            st = _adapt(st, adone, warmup)

        # G. advance t / it
        t_next = W(st.depth_done & ~last & (row_done | jump), pw_d - 1,
                   st.t + 1)
        new_t = W(done | ~live, 0, W(row_done | jump, t_next, st.t))
        d1 = col(done)
        moved = row_done | done | jump
        return st._replace(
            n=st.n + 1,
            t=new_t,
            it=st.it + done.to(torch.int32),
            qc=W(d1, st.q_prop, st.qc),
            lpc=W(done, st.lp_prop, st.lpc),
            gc=W(d1, st.g_prop, st.gc),
            second=st.second & ~moved,
            k=W(moved, -1, st.k),
        )

    return body


def _pair_uturn(st, v_orb, fw1, check_lvl, dtype):
    """U-turn checks at a pair's second member: the adjacent check
    between ``q1`` and the new state, and the merge checks against the
    span-start slab states in the expanded form ``v.qa - sum(v *
    slab_q)``, the slab cast up at each use (``megakernel.py:802-839``)."""
    W = torch.where
    eq = W(fw1, st.q1, st.qa)
    ev = W(fw1, st.v1, v_orb)
    lq = W(fw1, st.qa, st.q1)
    lv = W(fw1, v_orb, st.v1)
    adj_ut = uturn(eq, ev, lq, lv)
    vq = torch.sum(v_orb * st.qa, dim=-1)
    dot_new = vq[:, None] - torch.sum(
        st.slab_q.to(dtype) * v_orb[:, None, :], dim=-1)
    dot_old = torch.sum(
        st.slab_v.to(dtype) * st.qa[:, None, :], dim=-1) - torch.sum(
        st.slab_v.to(dtype) * st.slab_q.to(dtype), dim=-1)
    ut_all = W(fw1, (dot_new < 0.0) | (dot_old < 0.0),
               (dot_new > 0.0) | (dot_old > 0.0))
    return adj_ut | torch.any(check_lvl & ut_all, dim=1)


def _stage(st, store, target, dtype):
    """Latch the diagnostics row and stored summary of each chain in
    ``store`` into its free pending slot (``megakernel.py:906-963``)."""
    W = torch.where
    log_zero_edge = LOG_ZERO + 1.0
    either_passive = ((st.lwt_sum_b < log_zero_edge)
                      | (st.lwt_sum_f < log_zero_edge))
    nst_ = torch.clamp(st.n_states, min=1).to(dtype)

    def f(x):
        return x.to(dtype)

    diag_row = torch.stack([
        f(st.sel_l), f(st.n_doubl_sampled),
        st.orbit_len, st.orbit_len_sam,
        f(st.max_f_int), f(st.max_b_int),
        f(st.neval_f), f(st.neval_b),
        f(st.if_min), f(st.if_max),
        st.lwt_min, st.lwt_max,
        f(st.both_ends_passive), f(either_passive),
        f(st.n_if_neq_ib) / nst_,
        st.h_cur,
        f(st.n_if_zero) / nst_,
        st.h_max - st.h_min,
        st.delta_cur,
        f(st.stop_code), f(st.n_doubl_computed),
        f(st.c_min_d), f(st.c_max_d),
        st.index_stat,
    ], dim=0)  # [24, C]
    gen = target.generated(st.q_prop)
    use0 = store & ~st.pend0
    use1 = store & st.pend0   # slot 1 is free by construction
    return st._replace(
        pend0=st.pend0 | use0, pend1=st.pend1 | use1,
        prow0=W(use0, st.it, st.prow0), prow1=W(use1, st.it, st.prow1),
        pgen0=W(use0[:, None], gen, st.pgen0),
        pgen1=W(use1[:, None], gen, st.pgen1),
        pdiag0=W(use0[None, :], diag_row, st.pdiag0),
        pdiag1=W(use1[None, :], diag_row, st.pdiag1),
    )


def _adapt(st, adone, warmup):
    """Per-chain warmup at transition completion
    (``megakernel.py:965-985``): push the energy-error factor and, unless
    pooled, move each chain's delta and H to its own quantiles."""
    W = torch.where
    if warmup.adapt_delta:
        fac = (st.h_max - st.h_min) / st.delta_cur
        p2d = p2_push(st.p2d, fac, mask=adone)
        st = st._replace(p2d=p2d)
        if not warmup.pooled:
            dq = p2_quantile(p2d)
            st = st._replace(delta_cur=W(
                adone & (p2d.npush > 10) & (dq > 0),
                warmup.adapt_delta_target / dq, st.delta_cur))
    if warmup.adapt_h and not warmup.pooled:
        h_new = st.delta_cur ** (1.0 / 3.0) * torch.exp(p2_quantile(st.p2h))
        st = st._replace(h_cur=W(adone & (st.p2h.npush > 10), h_new,
                                 st.h_cur))
    return st


def flush(st: MState) -> MState:
    """Drain both pending slots into the output rings, each at its
    absolute draw index modulo the ring's length (slot 1 after slot 0)."""
    C = st.t.shape[0]
    cols = torch.arange(C, device=st.t.device)
    samples = st.samples.clone()
    diags = st.diags.clone()
    R, Rd = samples.shape[0], diags.shape[0]
    for pend, prow, pgen, pdiag in ((st.pend0, st.prow0, st.pgen0, st.pdiag0),
                                    (st.pend1, st.prow1, st.pgen1, st.pdiag1)):
        c = cols[pend]
        r = prow[pend].long()
        samples[r % R, c] = pgen[pend]
        diags[r % Rd, c] = pdiag.T[pend]
    zb = torch.zeros_like(st.pend0)
    return st._replace(samples=samples, diags=diags, pend0=zb, pend1=zb)


def _nanmedian(x):
    """numpy's median of the non-NaN values (the mean of the two middle
    ones for an even count; NaN when there are none), without a host
    sync: ``torch.nanmedian`` would return the lower middle value.  The
    middle pair is gathered with ``index_select``: indexing with a 0-dim
    tensor calls ``item()``, which waits for the device."""
    xs = torch.sort(x).values                    # NaN sorts last
    cnt = (~torch.isnan(x)).sum()
    qpos = 0.5 * (cnt.to(x.dtype) - 1.0)
    hi_cap = torch.clamp(cnt - 1, min=0)
    low = torch.minimum(torch.floor(qpos).long().clamp(min=0), hi_cap)
    high = torch.minimum(torch.ceil(qpos).long().clamp(min=0), hi_cap)
    mid = xs.index_select(0, torch.stack([low, high]))
    return (mid[0] + mid[1]) * 0.5


def pooled_consensus(st: MState, warmup: WarmupConfig, mesh=None):
    """Batch-median ``(h_cur, delta_cur)`` after a flush period
    (``megakernel.py:1295-1317``): applies while any chain is still in
    warmup, so all chains leave warmup with one ``(H, delta)``.  With
    the chains split over the ranks of ``mesh``, the iteration counts
    and the per-chain P2 quantiles are all-gathered in rank order (one
    collective), so every rank takes the median of the whole batch."""
    nan = float("nan")
    it = st.it
    qd = torch.where(st.p2d.npush > 10, p2_quantile(st.p2d), nan)
    qh = torch.where(st.p2h.npush > 10, p2_quantile(st.p2h), nan)
    if split(mesh):
        it, qd, qh = gather_rows(torch.stack([it.to(qd.dtype), qd, qh]),
                                 mesh, dim=1)
    in_wu = torch.min(it) < warmup.warmup_iter
    h_cur, delta_cur = st.h_cur, st.delta_cur
    if warmup.adapt_delta:
        med = _nanmedian(qd)
        delta_cur = torch.where(in_wu & torch.isfinite(med) & (med > 0),
                                warmup.adapt_delta_target / med, delta_cur)
    if warmup.adapt_h:
        med = _nanmedian(qh)
        h_cur = torch.where(in_wu & torch.isfinite(med),
                            delta_cur ** (1.0 / 3.0) * torch.exp(med), h_cur)
    return h_cur, delta_cur


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_state(q0, h_step, delta, *, target, cfg, warmup, num_iter,
               ring_rows=None, diag_rows=None, adapt_state=None) -> MState:
    """Fresh engine state (``megakernel.py:1164-1233``): every chain is
    flagged for fresh init (``k = -1, t = 0``)."""
    C, D = q0.shape
    dtype, dev = q0.dtype, q0.device
    _, min_c, _ = protocol(cfg)
    S = max(cfg.m - 2, 1)
    dg = target.generated_dim
    R = num_iter if ring_rows is None else ring_rows
    Rd = R if diag_rows is None else diag_rows
    lp0, g0 = target.logp_grad(q0)
    zf = torch.zeros((C,), dtype=dtype, device=dev)
    zv = torch.zeros_like(q0)

    def zi(v=0):
        return torch.full((C,), v, dtype=torch.int32, device=dev)

    zb = torch.zeros((C,), dtype=torch.bool, device=dev)
    if adapt_state is not None:
        p2h, p2d = adapt_state
    else:
        p2h = p2_init(1.0 - (warmup.adapt_h_target if warmup else 0.8),
                      (C,), dtype, dev)
        p2d = p2_init(warmup.adapt_delta_quantile if warmup else 0.9,
                      (C,), dtype, dev)
    return MState(
        n=0, t=zi(), it=zi(),
        phase=zi(), c_cur=zi(min_c), k=zi(-1),
        second=zb, h_loc=torch.ones_like(zf), coarse=zb, i_f=zi(),
        qs=q0, vs=zv, gs=g0, lps=lp0, h0s=zf,
        qt=q0, vt=zv, gt=g0, lpt=lp0, ht=zf, dht=zf, fint=torch.ones_like(zf),
        qa=q0, va=zv, ga=g0, lpa=lp0, ha=zf, dha=zf,
        c_sim=zi(), nev_f=zi(), nev_b=zi(),
        q1=q0, v1=zv,
        qp=q0, vp=zv, gp=g0, lpp=lp0, hp=zf,
        qm=q0, vm=zv, gm=g0, lpm=lp0, hm=zf,
        qc=q0, lpc=lp0, gc=g0,
        q_prop=q0, lp_prop=lp0, g_prop=g0,
        q_prop_last=q0, lp_prop_last=lp0, g_prop_last=g0,
        mscale=zf, lwt_sum_f=zf, lwt_sum_b=zf,
        w_new_sum=zf, w_old_sum=torch.ones_like(zf),
        sel_l=zi(), sel_l_old=zi(),
        idx_time=zf, index_stat=zf, index_stat_old=zf,
        time_f=zf, time_b=zf, orbit_len=zf, orbit_len_sam=zf,
        a_abs=zi(), b_abs=zi(),
        xi_bits=torch.zeros((C,), dtype=torch.int64, device=dev),
        depth_done=zb, stop_code=zi(), both_ends_passive=zb,
        n_doubl_sampled=zi(), n_doubl_computed=zi(),
        max_f_int=zi(), max_b_int=zi(), neval_f=zi(), neval_b=zi(),
        h_min=zf, h_max=zf,
        if_min=zi(_BIG_I32), if_max=zi(-_BIG_I32),
        c_min_d=zi(_BIG_I32), c_max_d=zi(-_BIG_I32),
        lwt_min=torch.full_like(zf, float("inf")),
        lwt_max=torch.full_like(zf, float("-inf")),
        n_states=zi(), n_if_neq_ib=zi(), n_if_zero=zi(),
        slab_q=torch.zeros((C, S, D), dtype=slab_dtype(dtype), device=dev),
        slab_v=torch.zeros((C, S, D), dtype=slab_dtype(dtype), device=dev),
        samples=torch.zeros((R, C, dg), dtype=dtype, device=dev),
        diags=torch.zeros((Rd, C, 24), dtype=dtype, device=dev),
        grad_ct=zi(),
        pend0=zb, pend1=zb, prow0=zi(), prow1=zi(),
        pgen0=torch.zeros((C, dg), dtype=dtype, device=dev),
        pgen1=torch.zeros((C, dg), dtype=dtype, device=dev),
        pdiag0=torch.zeros((24, C), dtype=dtype, device=dev),
        pdiag1=torch.zeros((24, C), dtype=dtype, device=dev),
        h_cur=torch.as_tensor(h_step, dtype=dtype, device=dev).expand(
            C).clone(),
        delta_cur=torch.as_tensor(delta, dtype=dtype, device=dev).expand(
            C).clone(),
        p2h=p2h, p2d=p2d,
    )


def mstate_from_numpy(d, device="cpu") -> MState:
    """A JAX ``_MState`` as numpy arrays (``{field: array}``, the
    ``P2State``s as mappings or named tuples of arrays) -> the port's
    state, so that a run started in JAX continues in the port.  bf16
    slabs may arrive as any float array holding bf16 values."""
    out = {}
    for name in MState._fields:
        v = d[name]
        if name == "n":
            out[name] = int(np.asarray(v))
        elif name in ("p2h", "p2d"):
            pv = v._asdict() if hasattr(v, "_asdict") else v
            out[name] = P2State(**{
                f: torch.from_numpy(np.array(pv[f])).to(device)
                for f in P2State._fields})
        elif name == "xi_bits":
            out[name] = torch.from_numpy(
                np.asarray(v).astype(np.uint32).astype(np.int64)).to(device)
        elif name in ("slab_q", "slab_v"):
            a = np.asarray(v)
            if a.dtype == np.float64:
                out[name] = torch.from_numpy(a.copy()).to(device)
            else:
                out[name] = torch.from_numpy(a.astype(np.float32)).to(
                    device=device, dtype=torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(v)).to(device)
    return MState(**out)


def mstate_to_numpy(st: MState) -> dict:
    """The port's state -> ``{field: numpy array}`` in the JAX
    ``_MState``'s dtypes (``xi_bits`` uint32; the ``P2State``s as dicts).
    A bf16 slab comes back as float32 holding the bf16 values."""
    out = {}
    for name in MState._fields:
        v = getattr(st, name)
        if name == "n":
            out[name] = np.asarray(v, np.int32)
        elif name in ("p2h", "p2d"):
            out[name] = {f: getattr(v, f).cpu().numpy()
                         for f in P2State._fields}
        elif name == "xi_bits":
            out[name] = v.cpu().numpy().astype(np.uint32)
        elif v.dtype == torch.bfloat16:
            out[name] = v.float().cpu().numpy()
        else:
            out[name] = v.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def key_hash_seed(key_seed: int) -> int:
    """The int32 hash seed that the JAX ``run_walnuts_fused`` derives from
    ``jax.random.PRNGKey(key_seed)`` (``megakernel.py:1258-1259``:
    ``randint(fold_in(key, 777), (1,), 0, 2^30, int32)``), the ``seed``
    that makes :func:`run_walnuts_fused` draw JAX's stream."""
    key = threefry.fold_in(threefry.PRNGKey(key_seed), 777)
    return int(threefry.randint(key, (1,), 0, 2 ** 30, torch.int32)[0])


stop_readbacks = 0  # blocking reads of the stop test made by _run


def live_periods(it, stop_mode: str, num_iter: int, C_total: int,
                 mesh=None) -> int:
    """How many more flush periods the stop test is certain not to end,
    from one blocking read of the draw counts ``it [C]`` (all-reduced
    over the ranks of ``mesh``, whose chains number ``C_total``); 0 where
    it ends the run now.

    A chain starts a transition only while one of its two pending slots
    is free, every transition it completes below ``num_iter`` fills a
    slot, and only the flush at a period's end empties them: a chain
    below ``num_iter`` gains at most 2 draws a period.  So the slowest
    chain of ``per_chain`` and ``min_per_chain``, ``m`` draws, stays
    below ``num_iter`` for ``ceil((num_iter - m) / 2)`` periods, and the
    ``total`` test's sum ``S`` stays below ``C_total * num_iter`` for
    ``ceil((C_total * num_iter - S) / (2 C_total))``.  Every rank reads
    the same count, so all make the same launches and collectives."""
    global stop_readbacks
    stop_readbacks += 1
    if stop_mode == "total":
        short = C_total * num_iter - reduce_int(it.sum(), mesh, "sum")
        per = 2 * C_total
    else:
        short = num_iter - reduce_int(it.min(), mesh, "min")
        per = 2
    return max(0, -(-short // per))


def run_walnuts_fused(seed, q0, h_step, delta, *, target,
                      cfg: WalnutsConfig, num_iter: int,
                      stop_mode: str = "per_chain",
                      warmup: WarmupConfig = None,
                      ring_rows: int = None,
                      diag_rows: int = None,
                      rounds: int = None,
                      mk_state: MState = None,
                      adapt_state=None,
                      micro_unroll: int = 1,
                      device=DEFAULT_DEVICE,
                      mesh=None):
    """Stream WALNUTS transitions for the chains ``q0 [C, D]`` (the
    JAX ``run_walnuts_fused`` with ``rng="hash"``).

    ``seed`` is the int32 hash seed (the JAX engine derives it from its
    key at ``megakernel.py:1258-1259``).  dtype comes from ``q0``.
    ``q0`` (a tensor or a numpy array), ``h_step``, ``delta``,
    ``mk_state`` and ``adapt_state`` are moved to ``device``, the card
    unless the caller passes ``device="cpu"``; without a card the
    default raises.  On the card every round runs in the hand-written
    kernel, for every target.  The targets with a ``kernel_id`` (funnel,
    std_gauss, Stock-Watson up to 256 rows) have their gradient fused
    into it; any other target runs its external-gradient instantiation,
    ``16 * micro_unroll + 1`` launches per flush period with one call of
    the target's own ``logp_grad`` on all chains between each two
    (``round_kernel._run_segments``).  The kernel stores the identity,
    :func:`..targets.analytic.omega_sumsq` and Stock-Watson summaries
    itself; any other summary is mapped in torch over the positions the
    kernel draws (``round_kernel.defer_summary``).
    :func:`run_walnuts_fused_plain` runs the plain twin on the card by
    name.  On the CPU the plain twin, the plain round body, runs.

    ``stop_mode``: ``"per_chain"`` (every chain stops at ``num_iter``
    draws), ``"total"`` (until ``C * num_iter`` draws exist; rings keep
    each chain's most recent draws) or ``"min_per_chain"`` (until every
    chain has ``num_iter`` draws; chains past quota keep transitioning
    and the rings keep each chain's first draws).  The host reads the
    stop test back once, queues every flush period of 16 rounds that the
    test cannot yet end (:func:`live_periods`), and reads it again:
    the periods that run are those of a test after every period.

    ``warmup``: ``h_step``/``delta`` are initial values, adapted in-loop
    for each chain's first ``warmup.warmup_iter`` transitions (per
    chain, or by batch median under ``warmup.pooled``).

    ``rounds`` caps the call at about that many rounds (flush-period
    granularity) and appends the engine state, which ``mk_state``
    resumes exactly.

    ``mesh`` (:func:`..parallel.make_mesh`): ``q0`` and the per-chain
    arguments are this rank's block of chains
    (:func:`..parallel.shard_chains`).  Its hash draws are keyed by the
    global chain ids, the stop test counts every rank's chains (an
    all-reduce per read) and the pooled consensus takes the
    whole batch's median, so every rank makes as many launches as one
    process would and returns its rows of that run.

    Returns ``(samples [R, C, dg], diagnostics [Rd, C, 24], q_final
    [C, D], counts [C], total_grads)``, plus ``(h, delta, (p2h, p2d))``
    under ``warmup``, plus the state under ``rounds``.  ``total_grads``
    is the exact int64 sum of the per-chain gradient counts (of this
    rank's chains under a ``mesh``: the caller sums over ranks).
    """
    from . import round_kernel

    return _run(round_kernel.run_rounds, seed, q0, h_step, delta,
                target=target, cfg=cfg, num_iter=num_iter,
                stop_mode=stop_mode, warmup=warmup, ring_rows=ring_rows,
                diag_rows=diag_rows, rounds=rounds, mk_state=mk_state,
                adapt_state=adapt_state, micro_unroll=micro_unroll,
                device=device, mesh=mesh)


def run_walnuts_fused_plain(seed, q0, h_step, delta, **kw):
    """:func:`run_walnuts_fused` with every flush period in the plain
    twin of the round kernel, on ``device`` (the card unless the caller
    passes ``device="cpu"``): the reference the kernel is held against
    on the card."""
    from . import round_kernel

    return _run(round_kernel.run_rounds_plain, seed, q0, h_step, delta, **kw)


def _run(run_period, seed, q0, h_step, delta, *, target, cfg, num_iter,
         stop_mode="per_chain", warmup=None, ring_rows=None, diag_rows=None,
         rounds=None, mk_state=None, adapt_state=None, micro_unroll=1,
         device=DEFAULT_DEVICE, mesh=None):
    from . import round_kernel

    # a mesh the engine cannot take raises before any work
    chains_only(mesh, FUSED_DIM_SPLIT_ITEM)
    dev = resolve_device(device)
    q0 = torch.as_tensor(q0).to(dev)
    h_step, delta, mk_state, adapt_state = (
        to_device(x, dev) for x in (h_step, delta, mk_state, adapt_state))
    C, D = q0.shape
    if not 1 <= cfg.m <= 32:
        raise ValueError(f"cfg.m must be in [1, 32], got {cfg.m}")
    if cfg.integrator not in INTEGRATORS:
        raise ValueError(
            "the fused engine implements the leapfrog R2P/D/fixed "
            f"protocols; got integrator={cfg.integrator!r}")
    if stop_mode not in STOP_MODES:
        raise ValueError(f"unknown stop_mode {stop_mode!r}")
    if q0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"q0 must be float32 or float64, got {q0.dtype}")
    if micro_unroll < 1:
        raise ValueError(f"micro_unroll must be >= 1, got {micro_unroll}")

    with trace.span("call"):
        st = mk_state if mk_state is not None else init_state(
            q0, h_step, delta, target=target, cfg=cfg, warmup=warmup,
            num_iter=num_iter, ring_rows=ring_rows, diag_rows=diag_rows,
            adapt_state=adapt_state)
        c0, C_total = chain_block(mesh, C)
        spec = round_kernel.RoundSpec(
            target=target, cfg=cfg, warmup=warmup, stop_mode=stop_mode,
            num_iter=num_iter, micro_unroll=micro_unroll, seed=int(seed),
            c0=c0)
        ring = None
        with trace.span("pack"):
            # on the card, a summary the kernel does not store is mapped
            # in torch over the positions it stages
            # (round_kernel.defer_summary)
            if run_period is round_kernel.run_rounds and \
                    dev.type == "cuda" and not round_kernel.check_card(spec):
                ring = st.samples.clone()
                ident, st = round_kernel.defer_summary(st, target)
                spec = spec._replace(target=ident)
            banks = round_kernel.pack(st)
        n = n0 = st.n
        view = round_kernel.unpack(banks, n)
        try:
            while True:
                # the periods the rounds cap leaves, known on the host and
                # the same on every rank: a call it ends reads no more
                left = math.inf if rounds is None else -(
                    (n - n0 - rounds) // FLUSH_EVERY)
                if left <= 0:
                    break
                # a turn: one blocking read of the stop test, then every
                # period it cannot end queued back to back
                with trace.span("period"):
                    with trace.span("readback"):
                        live = min(left, live_periods(
                            view.it, stop_mode, num_iter, C_total, mesh))
                    if not live:
                        break
                    for j in range(live):
                        it0 = None if ring is None else view.it.clone()
                        with trace.span("ahead" if j else "launch"):
                            run_period(banks, n, spec)
                        if ring is not None:
                            with trace.span("summarize"):
                                round_kernel.summarize(
                                    ring, view.samples, it0, view.it, target,
                                    stop_mode, num_iter)
                        n += FLUSH_EVERY
                        if warmup is not None and warmup.pooled:
                            with trace.span("consensus",
                                            device=dev.type == "cuda"):
                                h_cur, delta_cur = pooled_consensus(
                                    view, warmup, mesh)
                                view.h_cur.copy_(h_cur)
                                view.delta_cur.copy_(delta_cur)
        except BaseException:
            round_kernel.release_graphs()
            raise
        with trace.span("unpack"):
            # the external-gradient periods' CUDA graphs hold these banks
            round_kernel.release_graphs()
            st = round_kernel.unpack(banks, n)
            if ring is not None:
                st = st._replace(samples=ring,
                                 pgen0=target.generated(st.pgen0),
                                 pgen1=target.generated(st.pgen1))
            with trace.span("readback"):
                total_grads = int(st.grad_ct.to(torch.int64).sum())
    out = (st.samples, st.diags, st.qc, st.it, total_grads)
    if warmup is not None:
        out = out + (st.h_cur, st.delta_cur, (st.p2h, st.p2d))
    if rounds is not None:
        out = out + (st,)
    return out
