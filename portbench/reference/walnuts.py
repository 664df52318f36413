"""Plain reference of the fused WALNUTS engine, under fixed tuning or in
warmup.

Every chain advances by rounds: in each round a chain starts a fresh
transition if it has none, latches a macro step (a jittered step size
and the coarse draw of the R2P or D protocol), takes up to
``micro_unroll`` leapfrog micro steps of its current trial, finishes
trials and macro steps, extends its orbit by doubling with U-turn checks
over the spans it closes, selects a state by its multinomial weight and,
at the end of a transition, stages the draw.  Staged draws leave a chain
at the end of each period of ``FLUSH_EVERY`` rounds; a chain holding two
staged draws starts no fresh transition until then.

Every random number is a splitmix32 hash of (seed, chain id, absolute
round, purpose), so a chain's trajectory depends on its own id and
start alone, and any subset of chains can be followed on its own.

This is the algorithm of Bou-Rabee, Carpenter, Kleppe and Liu's WALNUTS
as the fused engine schedules it, written here in plain torch over
``[C]`` and ``[C, D]`` tensors.  It runs in the dtype of ``q0``; the
span-start slab is stored in ``slab_dtype``.  It keeps only the state
that decides the draws and the tuning (no diagnostics).

In warmup each chain keeps two P-squared estimators (:mod:`.p2`): of
the log of each macro step's step-size constant, ``h / 2^c`` over the
cube root of its largest energy change, pushed at every finite macro
step, and of each transition's energy range over delta, pushed at its
end, both while the chain has completed fewer than ``warmup_iter``
transitions.  Per chain, a transition's end then sets ``delta`` to the
target over the range's quantile and ``H`` to ``delta^(1/3)`` times the
exponential of the step-size quantile, once an estimator holds more
than ten values.  Pooled, the chains keep their tuning and the caller
sets it between periods (:func:`run`'s ``tuning``).
"""

import numpy as np
import torch

from . import p2

FLUSH_EVERY = 16
FWD, R2P, BWD = 0, 1, 2
LOG_ZERO = -700.0
WT_SUM_THRESH = 2.7189761758644324e-304  # exp(LOG_ZERO + 1)

_M32 = 0xFFFFFFFF
HASH_M1 = 0x9E3779B9
HASH_M2 = 0x85EBCA6B
HASH_M3 = 0xC2B2AE35


def _mul32(x, c):
    """``x * c mod 2^32`` for uint32 values held in int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The splitmix32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class HashDraws:
    """The per-round draws of chains ``cid`` [C] (int64 ids) under the
    int32 ``seed``: uniforms from the top 24 bits of a hash of (seed, id,
    round, purpose), the momentum by Box-Muller over two hashed uniforms
    per coordinate."""

    def __init__(self, seed, cid, D, dtype):
        dev = cid.device
        self.h_c = _mix32(((int(seed) & _M32) + _mul32(cid, HASH_M1)) & _M32)
        purpose = torch.arange(7, dtype=torch.int64, device=dev)
        self.p_m3 = (purpose * HASH_M3) & _M32                  # [7]
        lane = _mul32(torch.arange(D, dtype=torch.int64, device=dev),
                      HASH_M1)
        self.lane_m3 = self.p_m3[5:, None] + lane[None]         # [2, D]
        self.dtype = dtype

    def _u(self, bits):
        return (bits >> 8).to(self.dtype) * 2.0 ** -24

    def __call__(self, n):
        h_r = _mix32((self.h_c + ((int(n) * HASH_M2) & _M32)) & _M32)
        bits = _mix32((h_r[:, None] + self.p_m3[None, :5]) & _M32)
        lanes = _mix32((h_r[:, None, None] + self.lane_m3[None]) & _M32)
        u = self._u(bits)
        u1 = self._u(lanes[:, 0]) + 2.0 ** -25
        u2 = self._u(lanes[:, 1])
        mom = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            6.283185307179586 * u2)
        return dict(h_u=u[:, 0], co_u=u[:, 1], cat_u=u[:, 2], acc_u=u[:, 3],
                    dirs=bits[:, 4], mom=mom)


def _uturn(q_earlier, v_earlier, q_later, v_later):
    d = q_later - q_earlier
    return ((torch.sum(v_later * d, dim=-1) < 0.0)
            | (torch.sum(v_earlier * d, dim=-1) < 0.0))


class Sampler:
    """WALNUTS under fixed tuning for a batch of chains.

    ``sampler``: ``m`` (orbit depth cap, ``2^(m-1)`` macro steps),
    ``integrator`` (``adapt_leapfrog_r2p``, ``adapt_leapfrog_d`` or
    ``fixed_leapfrog``), ``min_c``, ``max_c``, ``r2p_prob0``,
    ``step_size_rand_scale``.  ``logp_grad(q) -> (lp [C], g [C, D])`` and
    ``summary(q) -> [C, dg]`` are the target's."""

    def __init__(self, sampler, logp_grad, summary, micro_unroll,
                 slab_dtype, warmup=None):
        self.m = int(sampler["m"])
        integ = sampler["integrator"]
        if integ not in ("adapt_leapfrog_r2p", "adapt_leapfrog_d",
                         "fixed_leapfrog"):
            raise ValueError(f"unknown integrator {integ!r}")
        self.proto_d = integ != "adapt_leapfrog_r2p"
        if integ == "fixed_leapfrog":
            self.min_c = self.max_c = 0
        else:
            self.min_c = int(sampler.get("min_c", 0))
            self.max_c = int(sampler.get("max_c", 10))
        self.p0 = float(sampler.get("r2p_prob0", 2.0 / 3.0))
        self.s_sc = float(sampler.get("step_size_rand_scale", 0.2))
        self.logp_grad = logp_grad
        self.summary = summary
        self.unroll = int(micro_unroll)
        self.slab_dtype = slab_dtype
        self.warmup = None if not warmup else dict(
            dict(warmup_iter=1000, adapt_h=True, adapt_h_target=0.8,
                 adapt_delta=True, adapt_delta_target=0.6,
                 adapt_delta_quantile=0.9, pooled=False), **warmup)
        self._const = {}

    def _consts(self, dt, dev):
        """``log p0``, ``log(1 - p0)`` and the weight-sum threshold, in
        float64 for a float64 run, else in float32 cast to the run
        dtype."""
        key = (dt, dev)
        if key not in self._const:
            np_dt = np.float64 if dt == torch.float64 else np.float32
            self._const[key] = tuple(
                torch.tensor(float(v), dtype=torch.float64).to(dev, dt)
                for v in (np.log(np.asarray(self.p0, np_dt)),
                          np.log(np.asarray(1.0 - self.p0, np_dt)),
                          np.asarray(WT_SUM_THRESH, np_dt)))
        return self._const[key]

    def init(self, q0, h, delta):
        """The state of chains about to start their first transition."""
        C, D = q0.shape
        dev, dt = q0.device, q0.dtype
        S = max(self.m - 2, 1)
        lp0, g0 = self.logp_grad(q0)
        zf = torch.zeros(C, dtype=dt, device=dev)
        zi = torch.zeros(C, dtype=torch.int32, device=dev)
        zb = torch.zeros(C, dtype=torch.bool, device=dev)
        s = dict(
            t=zi, k=zi - 1, phase=zi, c_cur=zi + self.min_c, i_f=zi,
            c_sim=zi, it=zi, pend=zi, grad_ct=zi, coarse=zb, second=zb,
            depth_done=zb,
            h_loc=zf + 1.0, fint=zf + 1.0, mscale=zf, lwt_sum_f=zf,
            lwt_sum_b=zf, w_new_sum=zf, w_old_sum=zf + 1.0,
            xi_bits=torch.zeros(C, dtype=torch.int64, device=dev),
            h_cur=h.to(dt).expand(C).clone(),
            delta_cur=delta.to(dt).expand(C).clone(),
            slab_q=torch.zeros((C, S, D), dtype=self.slab_dtype, device=dev),
            slab_v=torch.zeros((C, S, D), dtype=self.slab_dtype, device=dev),
        )
        for v in ("qs", "qt", "qa", "q1", "qp", "qm", "qc", "q_prop",
                  "q_prop_last"):
            s[v] = q0
        for v in ("vs", "vt", "va", "v1", "vp", "vm"):
            s[v] = torch.zeros_like(q0)
        for v in ("gs", "gt", "ga", "gp", "gm", "gc", "g_prop",
                  "g_prop_last"):
            s[v] = g0
        for v in ("lps", "lpt", "lpa", "lpp", "lpm", "lpc", "lp_prop",
                  "lp_prop_last"):
            s[v] = lp0
        for v in ("h0s", "ht", "ha", "hp", "hm", "dht", "dha", "h_min",
                  "h_max"):
            s[v] = zf
        wu = self.warmup
        s["p2h"] = p2.init(1.0 - (wu["adapt_h_target"] if wu else 0.8), C,
                           dt, dev)
        s["p2d"] = p2.init(wu["adapt_delta_quantile"] if wu else 0.9, C, dt,
                           dev)
        return s

    def round(self, s, rnd):
        """Advance every chain by one round; returns the chains that
        completed a transition and the summary of their draws."""
        W = torch.where
        m, min_c, max_c = self.m, self.min_c, self.max_c
        dt = s["qc"].dtype
        dev = s["qc"].device
        C = s["t"].shape[0]
        T = 2 ** (m - 1)
        S = max(m - 2, 1)
        lp_c, lp_f, thresh = self._consts(dt, dev)

        def col(x):
            return x[:, None]

        def put(mask, **kv):
            for k, v in kv.items():
                mk = col(mask) if s[k].ndim == 2 else mask
                s[k] = W(mk, v, s[k])

        # A. fresh transition: momentum, directions and the orbit at the
        #    current state (a chain holding two staged draws waits)
        needs_fresh = (s["k"] < 0) & (s["t"] == 0)
        stall = s["pend"] >= 2
        fresh = needs_fresh & ~stall
        v0 = rnd["mom"]
        h0f = -s["lpc"] + 0.5 * torch.sum(v0 * v0, dim=-1)
        put(fresh, qp=s["qc"], vp=v0, gp=s["gc"], lpp=s["lpc"], hp=h0f,
            qm=s["qc"], vm=v0, gm=s["gc"], lpm=s["lpc"], hm=h0f,
            q_prop=s["qc"], lp_prop=s["lpc"], g_prop=s["gc"],
            q_prop_last=s["qc"], lp_prop_last=s["lpc"],
            g_prop_last=s["gc"], mscale=h0f, lwt_sum_f=0.0, lwt_sum_b=0.0,
            w_new_sum=0.0, w_old_sum=1.0, xi_bits=rnd["dirs"], h_min=h0f,
            h_max=h0f)
        s["depth_done"] = s["depth_done"] & ~fresh
        s["second"] = s["second"] & ~fresh

        # the orbit row t: depth d holds rows [2^(d-1), 2^d); pair j of a
        # depth integrates its states 2j+1 and 2j+2
        t = s["t"]
        depth_t = torch.zeros_like(t)
        for j in range(m):
            depth_t = depth_t + (t >= (1 << j)).to(t.dtype)
        is_d0 = t == 0
        one = torch.ones_like(t)
        pw_d = one << depth_t
        last = t == pw_d - 1
        first = (t & (t - 1)) == 0
        j_pair = t - (one << torch.clamp(depth_t - 1, min=0))
        rel1 = W(is_d0, 1, 2 * j_pair + 1)
        rel2 = W(is_d0, 0, 2 * j_pair + 2)
        fwd = ((s["xi_bits"] >> depth_t.to(torch.int64)) & 1) == 1
        fw1 = col(fwd)

        # snapshot of the proposal at the first macro step of a depth
        snap = (first & ~is_d0 & (s["k"] < 0) & ~s["second"]
                & ~s["depth_done"])
        put(snap, q_prop_last=s["q_prop"], lp_prop_last=s["lp_prop"],
            g_prop_last=s["g_prop"], w_new_sum=0.0)

        # B. macro-step start from the orbit's end in its direction
        idle = s["depth_done"]
        starting = (s["k"] < 0) & ~idle & ~(needs_fresh & stall)
        h_draw = s["h_cur"] * ((1.0 - self.s_sc)
                               + rnd["h_u"] * (2.0 * self.s_sc))
        co_draw = (torch.ones(C, dtype=torch.bool, device=dev)
                   if self.proto_d else rnd["co_u"] < self.p0)
        q_e = W(fw1, s["qp"], s["qm"])
        v_e = W(fw1, s["vp"], -s["vm"])
        g_e = W(fw1, s["gp"], s["gm"])
        lp_e = W(fwd, s["lpp"], s["lpm"])
        h_e = W(fwd, s["hp"], s["hm"])
        put(starting, h_loc=h_draw, coarse=co_draw, phase=FWD, c_cur=min_c,
            k=0, qs=q_e, vs=v_e, gs=g_e, lps=lp_e, h0s=h_e, qt=q_e, vt=v_e,
            gt=g_e, lpt=lp_e, ht=h_e, dht=0.0, fint=1.0, i_f=max_c)

        # C. leapfrog micro steps of the current trial (2^c_cur of them)
        n_steps = one << s["c_cur"]
        base = (s["k"] >= 0) & ~idle
        for _ in range(self.unroll):
            integ = base & (s["k"] < n_steps)
            hh = col(W(integ, s["h_loc"] / n_steps.to(dt), 0.0))
            vh = s["vt"] + 0.5 * hh * s["gt"]
            q2 = s["qt"] + hh * vh
            lp2, g2 = self.logp_grad(q2)
            v2 = vh + 0.5 * hh * g2
            h2 = -lp2 + 0.5 * torch.sum(v2 * v2, dim=-1)
            fint = W(integ & ~torch.isfinite(h2), 0.0, s["fint"])
            put(integ, dht=torch.maximum(s["dht"], torch.abs(h2 - s["ht"])))
            put(integ, qt=q2, vt=v2, gt=g2, lpt=lp2, ht=h2, k=s["k"] + 1)
            s["fint"] = fint
            s["grad_ct"] = s["grad_ct"] + integ.to(torch.int32)

        # D. trial completion: forward search, R2P fine trial, backward
        #    (reversibility) search
        t_done = base & (s["k"] >= n_steps)
        t_fin = s["fint"] > 0.5
        err_ok = t_fin & (torch.abs(s["h0s"] - s["ht"]) < s["delta_cur"])
        f_done = t_done & (s["phase"] == FWD)
        f_acc = f_done & (err_ok | (s["c_cur"] == max_c))
        put(f_acc, i_f=s["c_cur"], qa=s["qt"], va=s["vt"], ga=s["gt"],
            lpa=s["lpt"], ha=s["ht"], dha=s["dht"], c_sim=s["c_cur"])
        f_retry = f_done & ~f_acc
        go_fine = f_acc & ~s["coarse"]
        go_bwd_f = f_acc & s["coarse"]
        r_done = t_done & (s["phase"] == R2P)
        put(r_done, qa=s["qt"], va=s["vt"], ga=s["gt"], lpa=s["lpt"],
            ha=s["ht"], dha=s["dht"], c_sim=s["c_cur"])
        b_done = t_done & (s["phase"] == BWD)
        b_err_ok = t_fin & (torch.abs(s["ha"] - s["ht"]) < s["delta_cur"])
        max_try = W(s["coarse"], s["i_f"] - 1, max_c)
        b_found = b_done & b_err_ok
        b_next = b_done & ~b_err_ok & (s["c_cur"] < max_try)
        b_exhaust = b_done & ~b_err_ok & (s["c_cur"] >= max_try)
        i_b = W(b_found, s["c_cur"], W(s["coarse"], s["i_f"], max_c))

        def reset(mask, q, v, g, lp, h0):
            put(mask, qt=q, vt=v, gt=g, lpt=lp, ht=h0, dht=0.0, fint=1.0,
                k=0)

        reset(f_retry, s["qs"], s["vs"], s["gs"], s["lps"], s["h0s"])
        put(f_retry, c_cur=s["c_cur"] + 1)
        reset(go_fine, s["qs"], s["vs"], s["gs"], s["lps"], s["h0s"])
        put(go_fine, phase=R2P, c_cur=s["i_f"] + 1)
        to_bwd = go_bwd_f | r_done
        bwd_has = W(s["coarse"], s["i_f"] - 1, max_c) >= min_c
        start_bwd = to_bwd & bwd_has
        reset(start_bwd, s["qa"], -s["va"], s["ga"], s["lpa"], s["ha"])
        put(start_bwd, phase=BWD, c_cur=min_c)
        reset(b_next, s["qa"], -s["va"], s["ga"], s["lpa"], s["ha"])
        put(b_next, c_cur=s["c_cur"] + 1)

        # E. macro step done: its weight, the orbit's new end, the
        #    multinomial selection and the span slab
        no_levels = to_bwd & ~bwd_has
        md = no_levels | b_found | b_exhaust
        i_b = W(no_levels, W(s["coarse"], s["i_f"], max_c), i_b)
        finite_m = torch.isfinite(s["ha"])
        ok = md & finite_m
        put(md, h_min=torch.minimum(s["h_min"], s["ha"]),
            h_max=torch.maximum(s["h_max"], s["ha"]))
        wu = self.warmup
        if wu and wu["adapt_h"]:
            # the macro step's step-size constant
            igr = (s["h_loc"] / torch.exp2(s["c_sim"].to(dt))
                   * torch.clamp(s["dha"], min=1e-30) ** (-1.0 / 3.0))
            s["p2h"] = p2.push(s["p2h"], torch.log(igr),
                               ok & (s["it"] < wu["warmup_iter"]))
        if self.proto_d:
            lwt = W(s["i_f"] == i_b, 0.0, LOG_ZERO).to(dt)
        else:
            lwt_f = W(s["coarse"], lp_c, lp_f)
            lwt_b = W(s["c_sim"] == i_b, lp_c,
                      W(s["c_sim"] == i_b + 1, lp_f, LOG_ZERO))
            lwt = (lwt_b - lwt_f).to(dt)
        v_orb = W(fw1, s["va"], -s["va"])
        af = ok & fwd
        ab = ok & ~fwd
        lwt_sum_f = s["lwt_sum_f"] + W(af, lwt, 0.0)
        lwt_sum_b = s["lwt_sum_b"] + W(ab, lwt, 0.0)
        lwt_dir = W(fwd, lwt_sum_f, lwt_sum_b)
        w_new = torch.exp(-s["ha"] + s["mscale"] + lwt_dir)
        w_new_sum = s["w_new_sum"] + W(ok, w_new, 0.0)
        sel = (ok & (w_new_sum > thresh) & (rnd["cat_u"] * w_new_sum < w_new)
               & ~is_d0) | (ok & is_d0)
        jlev = torch.arange(2, S + 2, dtype=torch.int32, device=dev)[None]
        pw_lev = torch.ones_like(jlev) << jlev
        lev_ok = jlev <= col(depth_t)
        store_lvl = (lev_ok & ((col(rel1) & (pw_lev - 1)) == 1)
                     & col(ok & ~s["second"]))
        check_lvl = (lev_ok & ((col(rel2) & (pw_lev - 1)) == 0)
                     & (col(rel2) >= pw_lev))
        put(af, qp=s["qa"], vp=v_orb, gp=s["ga"], lpp=s["lpa"], hp=s["ha"])
        put(ab, qm=s["qa"], vm=v_orb, gm=s["ga"], lpm=s["lpa"], hm=s["ha"])
        s.update(lwt_sum_f=lwt_sum_f, lwt_sum_b=lwt_sum_b,
                 w_new_sum=w_new_sum)
        put(sel, q_prop=s["qa"], lp_prop=s["lpa"], g_prop=s["ga"])
        sv = store_lvl[:, :, None]
        sdt = self.slab_dtype
        s["slab_q"] = W(sv, s["qa"][:, None, :].to(sdt), s["slab_q"])
        s["slab_v"] = W(sv, v_orb[:, None, :].to(sdt), s["slab_v"])
        forced = md & ~finite_m

        # the pair of macro steps: its first member waits for the second;
        # at the second, the U-turn checks of the pair and of the spans it
        # closes
        second_prev = s["second"]
        first_done = md & ~second_prev & ~is_d0 & finite_m
        put(first_done, q1=s["qa"], v1=v_orb, k=-1)
        s["second"] = s["second"] | first_done
        row_done = (md & (second_prev | is_d0) & finite_m) | forced
        pair_ok = md & second_prev & finite_m
        eq = W(fw1, s["q1"], s["qa"])
        ev = W(fw1, s["v1"], v_orb)
        lq = W(fw1, s["qa"], s["q1"])
        lv = W(fw1, v_orb, s["v1"])
        adj_ut = _uturn(eq, ev, lq, lv)
        slab_q = s["slab_q"].to(dt)
        slab_v = s["slab_v"].to(dt)
        vq = torch.sum(v_orb * s["qa"], dim=-1)
        dot_new = vq[:, None] - torch.sum(slab_q * v_orb[:, None, :], dim=-1)
        dot_old = (torch.sum(slab_v * s["qa"][:, None, :], dim=-1)
                   - torch.sum(slab_v * slab_q, dim=-1))
        ut_all = W(fw1, (dot_new < 0.0) | (dot_old < 0.0),
                   (dot_new > 0.0) | (dot_old > 0.0))
        ut = adj_ut | torch.any(check_lvl & ut_all, dim=1)
        s["depth_done"] = s["depth_done"] | (pair_ok & ut)

        # the end of a depth: keep or restore the proposal, then stop on a
        # U-turn of the whole orbit, all-passive weights or the depth cap
        done = forced
        jump = s["depth_done"] & ~last
        arrived = s["depth_done"] & last & (s["k"] < 0)
        p_mask = last & ((row_done & ~forced) | arrived)
        su = p_mask & s["depth_done"]
        go = p_mask & ~s["depth_done"]
        keep_new = rnd["acc_u"] * s["w_old_sum"] < s["w_new_sum"]
        restore = su | (go & ~keep_new)
        put(restore, q_prop=s["q_prop_last"], lp_prop=s["lp_prop_last"],
            g_prop=s["g_prop_last"])
        done = done | su
        joined = _uturn(s["qm"], s["vm"], s["qp"], s["vp"])
        edge = LOG_ZERO + 1.0
        passive = (s["lwt_sum_b"] < edge) & (s["lwt_sum_f"] < edge)
        stop_now = go & (joined | passive)
        done = done | stop_now
        cont = go & ~stop_now
        done = done | (cont & (s["t"] + 1 >= T))
        put(cont, w_old_sum=s["w_old_sum"] + s["w_new_sum"])
        s["depth_done"] = s["depth_done"] & ~p_mask

        if wu:
            self._adapt(s, done & (s["it"] < wu["warmup_iter"]))

        # F. stage the draws; G. advance the orbit row and the chain
        draws = self.summary(s["q_prop"])
        t_next = W(s["depth_done"] & ~last & (row_done | jump), pw_d - 1,
                   s["t"] + 1)
        s["t"] = W(done, 0, W(row_done | jump, t_next, s["t"]))
        moved = row_done | done | jump
        s["pend"] = s["pend"] + done.to(torch.int32)
        s["it"] = s["it"] + done.to(torch.int32)
        put(done, qc=s["q_prop"], lpc=s["lp_prop"], gc=s["g_prop"])
        s["second"] = s["second"] & ~moved
        put(moved, k=-1)
        return done, draws

    def _adapt(self, s, adone):
        """A warmup transition's end: push its energy range over delta;
        per chain, move delta and H to the estimators' quantiles."""
        W, wu = torch.where, self.warmup
        if wu["adapt_delta"]:
            s["p2d"] = p2.push(s["p2d"], (s["h_max"] - s["h_min"])
                               / s["delta_cur"], adone)
            if not wu["pooled"]:
                dq = p2.estimate(s["p2d"])
                s["delta_cur"] = W(adone & (s["p2d"]["npush"] > 10)
                                   & (dq > 0), wu["adapt_delta_target"] / dq,
                                   s["delta_cur"])
        if wu["adapt_h"] and not wu["pooled"]:
            h_new = s["delta_cur"] ** (1.0 / 3.0) * torch.exp(
                p2.estimate(s["p2h"]))
            s["h_cur"] = W(adone & (s["p2h"]["npush"] > 10), h_new,
                           s["h_cur"])


def run(sampler, q0, h, delta, *, seed, cid, rounds, n_draws, tuning=()):
    """Run the chains ``q0 [C, D]`` (global ids ``cid``) for ``rounds``
    rounds from round 0.  ``tuning[p]``, where given, is the chains'
    ``(H, delta)`` from the end of period ``p`` on (a pooled warmup's
    consensus).  Returns the final state and ``draws [C, n_draws, dg]``,
    each chain's first draws (draw i valid for ``i < min(state["it"],
    n_draws)``)."""
    C, D = q0.shape
    rnd_of = HashDraws(seed, cid, D, q0.dtype)
    s = sampler.init(q0, h, delta)
    out = None
    rows = torch.arange(C, device=q0.device)
    for n in range(rounds):
        count = s["it"].long()
        done, draws = sampler.round(s, rnd_of(n))
        if out is None:
            out = draws.new_zeros((C, n_draws, draws.shape[-1]))
        keep = done & (count < n_draws)
        idx = torch.clamp(count, max=n_draws - 1)
        out[rows, idx] = torch.where(keep[:, None], draws, out[rows, idx])
        if (n + 1) % FLUSH_EVERY == 0:
            s["pend"] = torch.zeros_like(s["pend"])
            p = (n + 1) // FLUSH_EVERY - 1
            if p < len(tuning):
                s["h_cur"], s["delta_cur"] = (x.to(s["h_cur"])
                                              for x in tuning[p])
    return s, out
