"""Adaptive macro-step integrators (``walnuts_tpu/ops/integrators.py``).

Each integrator advances a batch of chains by one macro step of
per-chain length ``h_macro``, choosing a refinement level ``c`` so that
``2^c`` micro steps meet the error tolerance ``delta``, and returns the
reversibility bookkeeping ``(If, Ib, c, lwt)`` that the orbit layer
folds into its multinomial weights: ``fixed_leapfrog``, the
deterministic-halving D family (leapfrog, Yoshida, leapfrog with the
flow criterion, implicit midpoint, per-coordinate rescaled leapfrog)
and the randomized two-point ``adapt_leapfrog_r2p``.

As in the JAX version a shared refinement counter ``c`` sweeps upward
and every chain that has not yet accepted re-integrates its macro step
at ``2^c`` micro steps, with accepted chains masked out.  Each sweep is
a Python loop that checks ``any(~done)`` once per level (one host sync).

Where the JAX integrators take a PRNG key, these take ``coin``: R2P's
pre-drawn uniform, which the others ignore (``None`` is fine there).

Inside a dim split (:mod:`..parallel.mesh`) every energy, per-chain
error and per-chain flag is reduced over the dim group, so each rank of
a group sweeps the same levels.
"""

import math
from functools import partial
from typing import NamedTuple

import torch

from ..parallel.mesh import dim_all, dim_any, dim_sum
from ..utils.constants import LOG_ZERO
from ..utils.tree import tree_where
from .leapfrog import (MultistepResult, PhasePoint, implicit_midpoint_step,
                       leapfrog_flow_step, leapfrog_step, masked_multistep,
                       yoshida_step)

_IGR_FLOOR = 1e-30  # guards max_dh == 0 -> inf in the d^{-1/3} model


class IntegratorConfig(NamedTuple):
    """Static tuning record (reference ``integratorAuxPar``)."""

    min_c: int = 0
    max_c: int = 10
    r2p_prob0: float = 2.0 / 3.0
    max_fp_iter: int = 30
    fp_tol: float = 1.0e-8
    fp_newton: bool = False
    rescaled_grad_thresh: float = 5.0


class IntegratorResult(NamedTuple):
    """Batched analogue of the reference ``integratorReturn``; ``v`` is
    re-oriented to orbit time (the reference's ``xi*vOut``)."""

    q: torch.Tensor          # [C, D]
    v: torch.Tensor          # [C, D]
    g: torch.Tensor          # [C, D]
    lp: torch.Tensor         # [C]
    h_end: torch.Tensor      # [C] Hamiltonian at the new state
    n_eval_f: torch.Tensor   # [C] int32 logical gradient evals, forward
    n_eval_b: torch.Tensor   # [C] int32 logical gradient evals, backward
    i_f: torch.Tensor        # [C] int32
    i_b: torch.Tensor        # [C] int32
    c: torch.Tensor          # [C] int32 refinement actually simulated
    lwt: torch.Tensor        # [C] log Hastings weight contribution
    igr_const: torch.Tensor  # [C] h_micro * max|dH|^{-1/3} local-error const


def _pow2(c):
    """``2^c`` as int32 (``c`` an int or an int32 tensor)."""
    if isinstance(c, int):
        return 1 << c
    return torch.ones_like(c) << c


def _igr(h_micro, max_dh):
    return h_micro * torch.clamp(max_dh, min=_IGR_FLOOR) ** (-1.0 / 3.0)


def _trial_error(trial: MultistepResult, h0, criterion):
    if criterion == "energy":
        return torch.abs(h0 - trial.h_end)
    return trial.max_step_err


def _zeros_i(x):
    return torch.zeros(x.shape, dtype=torch.int32, device=x.device)


def _forward_search(target, start, h0, h_macro, delta, inv_mass, cfg,
                    step_fn, criterion, active):
    """Sweep c = min_c..max_c; per chain take the first accepted trial,
    or the max_c trial if none accepts (``adaptiveIntegrators.py:69-94``)."""
    zeros_i = _zeros_i(h0)
    result = MultistepResult(
        start, h0, torch.zeros_like(h0), torch.zeros_like(h0),
        torch.ones(h0.shape, dtype=torch.bool, device=h0.device), zeros_i)
    done = ~active
    i_f, igr, neval = zeros_i, torch.zeros_like(h0), zeros_i
    c = cfg.min_c
    while c <= cfg.max_c and bool((~done).any()):
        nsteps = torch.where(done, 0, _pow2(c)).to(torch.int32)
        h_micro = h_macro / float(_pow2(c))
        trial = masked_multistep(target, start, h0, h_micro, nsteps,
                                 inv_mass, step_fn)
        err = _trial_error(trial, h0, criterion)
        accept = trial.all_finite & (err < delta)
        take = ~done & (accept | (c == cfg.max_c))
        result = tree_where(take, trial, result)
        i_f = torch.where(take, c, i_f)
        igr = torch.where(take, _igr(h_micro, trial.max_dh), igr)
        neval = neval + trial.n_evals
        done = done | take
        c += 1
    return result, i_f, igr, neval


def _backward_search(target, end: PhasePoint, h0b, h_macro, delta, inv_mass,
                     cfg, step_fn, criterion, max_try, default_ib, active):
    """Sweep c = min_c..max_try (per-chain bound) from the flipped
    endpoint; the first accepted c is ``Ib``
    (``adaptiveIntegrators.py:107-132,440-464``)."""
    start_b = PhasePoint(end.q, -end.v, end.g, end.lp)
    found = ~active
    i_b, neval = default_ib, _zeros_i(h0b)
    c = cfg.min_c
    while bool((~found & (c <= max_try)).any()):
        do = ~found & (c <= max_try)
        nsteps = torch.where(do, _pow2(c), 0).to(torch.int32)
        h_micro = h_macro / float(_pow2(c))
        trial = masked_multistep(target, start_b, h0b, h_micro, nsteps,
                                 inv_mass, step_fn)
        err = _trial_error(trial, h0b, criterion)
        accept = do & trial.all_finite & (err < delta)
        i_b = torch.where(accept, c, i_b)
        neval = neval + trial.n_evals
        found = found | accept
        c += 1
    return i_b, neval


def _oriented_start(q, v, g, lp, xi):
    return PhasePoint(q, xi[:, None] * v, g, lp)


def _finish(start, end: PhasePoint, xi, h_end, active, lp_in, h0,
            n_eval_f, n_eval_b, i_f, i_b, c_sim, lwt, igr):
    """Re-orient the velocity to orbit time and freeze inactive chains."""
    a1 = active[:, None]
    W = torch.where
    return IntegratorResult(
        q=W(a1, end.q, start.q),
        v=W(a1, xi[:, None] * end.v, xi[:, None] * start.v),
        g=W(a1, end.g, start.g),
        lp=W(active, end.lp, lp_in),
        h_end=W(active, h_end, h0),
        n_eval_f=W(active, n_eval_f, 0),
        n_eval_b=W(active, n_eval_b, 0),
        i_f=W(active, i_f, 0),
        i_b=W(active, i_b, 0),
        c=W(active, c_sim, 0),
        lwt=W(active, lwt, 0.0),
        igr_const=W(active, igr, 1.0),
    )


# ----------------------------------------------------------------------
def fixed_leapfrog(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                   inv_mass, active, cfg):
    """Plain single leapfrog step (``adaptiveIntegrators.py:49-59``)."""
    start = _oriented_start(q, v, g, lp, xi)
    hh = torch.where(active, h_macro, 0.0)
    end, _, _, _ = leapfrog_step(target, start, hh, inv_mass)
    h_end = -end.lp + 0.5 * dim_sum(torch.sum(
        end.v * (end.v if inv_mass is None else inv_mass * end.v), dim=-1))
    igr = h_macro * torch.clamp(torch.abs(h0 - h_end),
                                min=1.0e-10) ** (-1.0 / 3.0)
    zi = _zeros_i(h0)
    return _finish(start, end, xi, h_end, active, lp, h0,
                   zi + 1, zi, zi, zi, zi, torch.zeros_like(h0), igr)


def _adaptive_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta, inv_mass,
                active, cfg, step_fn, criterion):
    """Deterministic halving protocol shared by the D family."""
    start = _oriented_start(q, v, g, lp, xi)
    fw, i_f, igr, n_eval_f = _forward_search(
        target, start, h0, h_macro, delta, inv_mass, cfg, step_fn,
        criterion, active)
    end = fw.state
    bw_active = active & (i_f > cfg.min_c)
    i_b, n_eval_b = _backward_search(
        target, end, fw.h_end, h_macro, delta, inv_mass, cfg, step_fn,
        criterion, max_try=i_f - 1, default_ib=i_f, active=bw_active)
    lwt = torch.where(i_f != i_b, LOG_ZERO, 0.0).to(h0.dtype)
    return _finish(start, end, xi, fw.h_end, active, lp, h0,
                   n_eval_f, n_eval_b, i_f, i_b, i_f, lwt, igr)


def adapt_leapfrog_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                     inv_mass, active, cfg):
    return _adaptive_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg, leapfrog_step, "energy")


def adapt_yoshida_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                    inv_mass, active, cfg):
    return _adaptive_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg, yoshida_step, "energy")


def adapt_leapfrog_flow_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                          inv_mass, active, cfg):
    # The reference's flow variant searches from c=0 whatever min_c is
    # (``adaptiveIntegrators.py:250``).
    cfg0 = cfg._replace(min_c=0)
    return _adaptive_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg0, leapfrog_flow_step, "flow")


def adapt_implicit_midpoint_d(coin, target, q, v, g, lp, h0, h_macro, xi,
                              delta, inv_mass, active, cfg):
    """Implicit midpoint with per-micro-step fixed-point (or Newton)
    solves under the deterministic halving protocol
    (``adaptiveIntegrators.py:478-641``).  A level at which a micro step
    fails to converge is rejected through the trial's ``all_finite``;
    if that persists through ``max_c`` the returned energy is
    non-finite and the orbit layer force-rejects (stop code 999)."""
    step_fn = partial(
        implicit_midpoint_step,
        fp_tol=cfg.fp_tol, max_fp_iter=cfg.max_fp_iter, newton=cfg.fp_newton)
    return _adaptive_d(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg, step_fn, "energy")


def adapt_leapfrog_r2p(coin, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg):
    """Randomized two-point refinement (``adaptiveIntegrators.py:361-475``).

    With probability ``r2p_prob0`` the macro step is simulated at the
    minimal accepted refinement ``If``, otherwise at ``If + 1``; the
    backward pass recomputes the minimal refinement ``Ib`` from the
    endpoint and ``lwt = log p(c_sim | Ib) - log p(c_sim | If)``.

    ``coin`` is the ``[C]`` float64 uniform that picks the coarse level,
    JAX's ``uniform(key, [C])`` with x64 on; the transition draws it
    with :func:`..utils.threefry.uniform`.
    """
    start = _oriented_start(q, v, g, lp, xi)
    fw, i_f, igr_f, n_eval_f = _forward_search(
        target, start, h0, h_macro, delta, inv_mass, cfg, leapfrog_step,
        "energy", active)

    coarse = coin < cfg.r2p_prob0
    c_fine = i_f + 1
    nsteps_x = torch.where(active & ~coarse, _pow2(c_fine), 0)
    h_micro_x = h_macro / _pow2(c_fine).to(h_macro.dtype)
    trial_x = masked_multistep(target, start, h0, h_micro_x, nsteps_x,
                               inv_mass, leapfrog_step)
    taken = tree_where(coarse, fw, trial_x)
    igr = torch.where(coarse, igr_f, _igr(h_micro_x, trial_x.max_dh))
    n_eval_f = n_eval_f + trial_x.n_evals
    c_sim = torch.where(coarse, i_f, c_fine)

    max_try = torch.where(coarse, i_f - 1, cfg.max_c)
    default_ib = torch.where(coarse, i_f, cfg.max_c)
    bw_active = active & (max_try >= cfg.min_c)
    i_b, n_eval_b = _backward_search(
        target, taken.state, taken.h_end, h_macro, delta, inv_mass, cfg,
        leapfrog_step, "energy", max_try, default_ib, bw_active)

    log_p0 = math.log(cfg.r2p_prob0)
    log_p1 = math.log(1.0 - cfg.r2p_prob0)
    # the log-weights are float64 Python constants, as JAX's weak types
    f64 = torch.zeros(h0.shape, dtype=torch.float64, device=h0.device)
    lwt_f = torch.where(coarse, f64 + log_p0, log_p1)
    lwt_b = torch.where(
        c_sim == i_b, f64 + log_p0,
        torch.where(c_sim == i_b + 1, f64 + log_p1, LOG_ZERO))
    lwt = (lwt_b - lwt_f).to(h0.dtype)
    return _finish(start, taken.state, xi, taken.h_end, active, lp, h0,
                   n_eval_f, n_eval_b, i_f, i_b, c_sim, lwt, igr)


def _rescaled_sweep(target, q_from, g_from, v_from, h_macro, h0_ref, delta,
                    thresh, cfg, active, sred_match=None):
    """One direction of the per-coordinate rescaled-leapfrog search
    (``adaptiveIntegrators.py:660-762``): repeat a single leapfrog step
    in coordinates ``q / Sd`` with ``Sd = 2^{-Sred}``, escalating
    ``Sred`` per coordinate where the mean rescaled gradient magnitude
    exceeds ``thresh``, or globally on a non-finite or over-tolerance
    energy error, until the step is accepted.  With ``sred_match``
    (backward pass) also stop as soon as ``Sred`` equals the forward
    pass's vector (reference ``:745-748``, ``Ib = c + 1`` then)."""
    C, D = q_from.shape
    dtype, dev = q_from.dtype, q_from.device
    neval = torch.zeros((C,), dtype=torch.int32, device=dev)
    sred = torch.zeros((C, D), dtype=torch.int32, device=dev)
    out_state = PhasePoint(q_from, v_from, g_from,
                           torch.zeros((C,), dtype=dtype, device=dev))
    out_h = torch.full((C,), torch.inf, dtype=dtype, device=dev)
    i_acc = torch.full((C,), cfg.max_c, dtype=torch.int32, device=dev)
    done = ~active
    c = 0
    while c <= cfg.max_c and bool((~done).any()):
        sd = torch.exp2(-sred.to(dtype))
        h = h_macro[:, None]
        gb = sd * g_from
        vh = v_from + 0.5 * h * gb
        qbn = q_from / sd + h * vh
        q1 = qbn * sd
        lp1, g1 = target.logp_grad(q1)
        gb1 = sd * g1
        v1 = vh + 0.5 * h * gb1
        ham1 = -lp1 + 0.5 * dim_sum(torch.sum(v1 * v1, dim=-1))
        gb_mean = 0.5 * (torch.abs(gb) + torch.abs(gb1))

        finite = torch.isfinite(ham1)
        too_big = gb_mean > thresh
        any_big = dim_any(torch.any(too_big, dim=-1))
        e_bad = torch.abs(h0_ref - ham1) > delta
        accept = finite & ~any_big & ~e_bad

        # at max_c the trial is kept regardless, like the reference's
        # fall-through (qOut = last q1 when the loop never breaks)
        take = ~done & (accept | (c == cfg.max_c))
        out_state, out_h = tree_where(
            take, (PhasePoint(q1, v1, g1, lp1), ham1), (out_state, out_h))
        i_acc = torch.where(~done & accept, c, i_acc)
        neval = neval + (~done).to(torch.int32)

        # escalation (order matters: non-finite beats per-coordinate)
        bump_all = ~finite | (finite & ~any_big & e_bad)
        sred_new = torch.where(
            bump_all[:, None], sred + 1,
            torch.where((finite & any_big)[:, None] & too_big, sred + 1,
                        sred))
        done_new = done | take
        if sred_match is not None:
            matched = ~done_new & dim_all(
                torch.all(sred_new == sred_match, dim=-1))
            i_acc = torch.where(matched, c + 1, i_acc)
            done_new = done_new | matched
        sred = torch.where(done[:, None], sred, sred_new)
        done = done_new
        c += 1
    return out_state, out_h, sred, i_acc, neval


def adapt_rescaled_leapfrog_d(coin, target, q, v, g, lp, h0, h_macro, xi,
                              delta, inv_mass, active, cfg):
    """Experimental per-coordinate step rescaling
    (``adaptiveIntegrators.py:660-762``).  Reversibility compares the
    forward and backward ``Sred`` vectors; a mismatch weights the state
    to log-zero.  The diagonal inverse mass is ignored, as in the
    reference."""
    del inv_mass  # identity metric, as in the reference
    start = _oriented_start(q, v, g, lp, xi)
    thresh = cfg.rescaled_grad_thresh
    fw_state, fw_h, sred_f, i_f, n_eval_f = _rescaled_sweep(
        target, start.q, start.g, start.v, h_macro, h0, delta, thresh, cfg,
        active)

    bw_active = active & (i_f > 0)
    _, _, sred_b, i_b0, n_eval_b = _rescaled_sweep(
        target, fw_state.q, fw_state.g, -fw_state.v, h_macro, fw_h, delta,
        thresh, cfg, bw_active, sred_match=sred_f)
    i_b = torch.where(i_f > 0, i_b0, i_f)
    sred_b = torch.where(bw_active[:, None], sred_b, sred_f)

    mismatch = dim_any(torch.any(sred_b != sred_f, dim=-1))
    lwt = torch.where(mismatch, LOG_ZERO, 0.0).to(h0.dtype)
    igr = torch.ones_like(h0)
    return _finish(start, fw_state, xi, fw_h, active, lp, h0,
                   n_eval_f, n_eval_b, i_f, i_b, i_f, lwt, igr)


INTEGRATORS = {
    "fixed_leapfrog": fixed_leapfrog,
    "adapt_leapfrog_d": adapt_leapfrog_d,
    "adapt_yoshida_d": adapt_yoshida_d,
    "adapt_leapfrog_flow_d": adapt_leapfrog_flow_d,
    "adapt_leapfrog_r2p": adapt_leapfrog_r2p,
    "adapt_implicit_midpoint_d": adapt_implicit_midpoint_d,
    "adapt_rescaled_leapfrog_d": adapt_rescaled_leapfrog_d,
}


def get_integrator(name):
    try:
        return INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; available: {sorted(INTEGRATORS)}"
        ) from None
