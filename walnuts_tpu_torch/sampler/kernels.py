"""Pluggable step kernels for the generic-step NUTS and the multinomial
samplers (``walnuts_tpu/sampler/kernels.py``).

A kernel bundles the state conventions of one dynamics:

* ``init/refresh/flip``: state construction and momentum handling;
* ``velocity``: what enters U-turn checks;
* ``ham``: the energy whose negative exponent weights states;
* ``step``: one adaptive macro step returning ``(state, lwt,
  StepStats)``.

``refresh`` takes a threefry key (:mod:`..utils.threefry`), so a kernel
draws JAX's momenta, and ``block = (c0, C_total)`` for a rank's chains
``c0 ..`` of a batch split over ranks (their rows of the whole draw).
``step`` takes the JAX version's unused key as its first argument.
Every refinement search is a host loop with one ``any`` per level, as
in :mod:`..ops.isokinetic`.  Inside a dim split a refresh draws the
rank's columns of the whole draw, and the energies and distances are
the dim group's sums and maxima.
"""

from typing import NamedTuple

import torch

from ..ops.isokinetic import (MCState, StepStats, adapt_mc_step_e,
                              adapt_mc_step_flow2, c_obs_stat, draw_window,
                              fixed_mc_step, isokinetic_multistep, refresh_u,
                              where_state)
from ..ops.leapfrog import PhasePoint, leapfrog_step, masked_multistep
from ..parallel.mesh import dim_max, dim_sum
from ..utils import threefry
from ..utils.constants import LOG_ZERO


def _dist(qa, ua, qb, ub, flip_u):
    dq = torch.amax(torch.abs(qa - qb), dim=-1)
    du = torch.amax(torch.abs(ua + ub if flip_u else ua - ub), dim=-1)
    return dim_max(torch.maximum(dq, du))


def _traj_search(integrate, s0: MCState, act, h_macro, delta, c_min, c_max):
    """One direction of the trajectory-comparison protocol: per level
    ``c`` a trial at ``2^c`` micro steps, accepted where it moved less
    than ``delta`` from the previous level's endpoint and a reversal at
    level ``c - 1`` returns within ``delta`` of the start."""
    C, D = s0.q.shape
    dtype, dev = s0.q.dtype, s0.q.device
    zf = torch.zeros((C,), dtype=dtype, device=dev)
    prev_q = prev_u = torch.full((C, D), 1.0e30, dtype=dtype, device=dev)
    done = ~act
    out, w_out = s0, zf
    ok_out = torch.ones((C,), dtype=torch.bool, device=dev)
    i_acc = torch.full((C,), c_max, dtype=torch.int32, device=dev)
    cobs = zf
    nev = torch.zeros((C,), dtype=torch.int32, device=dev)
    c = c_min
    while c <= c_max and bool((~done).any()):
        nsteps = torch.where(done, 0, 1 << c).to(torch.int32)
        h_micro = h_macro / float(1 << c)
        r_state, r_jac, r_ok, r_nev = integrate(s0, h_micro, nsteps)
        err = _dist(r_state.q, r_state.u, prev_q, prev_u, False)
        cand = ~done & r_ok & (err < delta)

        # reversal check at level c-1 (masked)
        cb = max(c - 1, 0)
        nb = torch.where(cand, 1 << cb, 0).to(torch.int32)
        rb_state, _, rb_ok, rb_nev = integrate(
            r_state._replace(u=-r_state.u), h_macro / float(1 << cb), nb)
        err_b = _dist(rb_state.q, rb_state.u, s0.q, s0.u, True)
        accept = cand & rb_ok & (err_b < delta)

        n_half = float((1 << c) // 2)
        cobs_c = c_obs_stat(torch.maximum(err, err_b), n_half, h_macro)

        take = accept | (~done & (c == c_max))
        out = where_state(take, r_state, out)
        w_out = torch.where(take, r_jac, w_out)
        ok_out = torch.where(take, r_ok, ok_out)
        i_acc = torch.where(take, c, i_acc)
        cobs = torch.where(take, cobs_c, cobs)
        nev = nev + r_nev + rb_nev
        prev_q = torch.where(done[:, None], prev_q, r_state.q)
        prev_u = torch.where(done[:, None], prev_u, r_state.u)
        done = done | take
        c += 1
    return out, w_out, ok_out, i_acc, cobs, nev


def _traj_flow_step(integrate, state, h_macro, delta, active, c_min, c_max):
    """Trajectory-comparison flow-error halving protocol shared by
    ``adaptMCstepFlow`` and ``adaptHMCstepF``: two integrations per
    level (the trial and its reversal), in a forward search and, where
    ``If > c_min + 1``, a backward search from the flipped endpoint.

    ``integrate(state, h_micro, nsteps) -> (state, log_jac, ok, nev)``
    runs one refinement trial."""
    C = state.q.shape[0]
    out, w_out, ok_out, i_f, cobs, nev_f = _traj_search(
        integrate, state, active, h_macro, delta, c_min, c_max)

    bw_active = active & (i_f > c_min + 1)
    _, _, _, i_b0, _, nev_b = _traj_search(
        integrate, out._replace(u=-out.u), bw_active, h_macro, delta, c_min,
        c_max)
    i_b = torch.where(bw_active, torch.minimum(i_b0, i_f), i_f)

    lwt = -w_out + torch.where(i_b < i_f, LOG_ZERO, 0.0)
    lwt = torch.where(ok_out, lwt, LOG_ZERO)
    lwt = torch.where(active, lwt, 0.0)
    stats = StepStats(
        n_evals=torch.where(active, nev_f + nev_b, 0),
        i_f=torch.where(active, i_f, 0),
        i_b=torch.where(active, i_b, 0),
        energy_err=torch.zeros((C,), dtype=state.q.dtype,
                               device=state.q.device),
        c_obs=torch.where(active, cobs, 0.0),
        basic=active & (i_f <= c_min + 1),
    )
    return where_state(active, out, state), lwt, stats


class IsokineticKernel(NamedTuple):
    """Isokinetic dynamics with unit-sphere velocity.

    ``variant``: ``"energy"`` = modified-energy halving
    (``adaptMCstepE``), ``"flow"`` = trajectory-comparison flow error
    (``adaptMCstepFlow``), ``"flow2"`` = Euler-comparison flow error
    (``adaptMCstepFlow2``).  ``adaptive=False`` = single fixed step
    (``fixedMCstep``)."""

    c_min: int = 0
    c_max: int = 10
    adaptive: bool = True
    variant: str = "energy"

    def init(self, target, q):
        lp, g = target.logp_grad(q)
        return MCState(q, torch.zeros_like(q), g, lp)

    def refresh(self, key, state, block=None):
        shape, rows, cols = draw_window(state.q.shape, block)
        return state._replace(u=refresh_u(key, shape, state.q.dtype, rows,
                                          cols))

    def flip(self, state):
        return state._replace(u=-state.u)

    def velocity(self, state):
        return state.u

    def ham(self, state):
        return -state.lp

    def step(self, key, target, state, h_macro, delta, active):
        if not self.adaptive:
            return fixed_mc_step(key, target, state, h_macro, delta, active,
                                 c_min=self.c_min, c_max=self.c_max)
        if self.variant == "energy":
            return adapt_mc_step_e(key, target, state, h_macro, delta,
                                   active, c_min=self.c_min,
                                   c_max=self.c_max)
        if self.variant == "flow2":
            return adapt_mc_step_flow2(key, target, state, h_macro, delta,
                                       active, c_min=self.c_min,
                                       c_max=self.c_max)
        if self.variant == "flow":
            def integrate(s, h_micro, nsteps):
                r = isokinetic_multistep(target, s, h_micro, nsteps)
                return r.state, r.log_jac, r.all_ok, r.n_evals

            return _traj_flow_step(integrate, state, h_macro, delta, active,
                                   self.c_min, self.c_max)
        raise ValueError(f"unknown isokinetic variant {self.variant!r}")


class HMCKernel(NamedTuple):
    """Hamiltonian dynamics with Gaussian momentum; ``adaptHMCstepE``'s
    energy-error halving protocol.  The state reuses ``MCState`` with
    ``u`` holding the full velocity.

    ``variant``: ``"energy"`` = energy-error halving (``adaptHMCstepE``),
    ``"flow"`` = trajectory-comparison flow error with explicit reversal
    checks (``adaptHMCstepF``)."""

    c_min: int = 0
    c_max: int = 10
    adaptive: bool = True
    variant: str = "energy"

    def init(self, target, q):
        lp, g = target.logp_grad(q)
        return MCState(q, torch.zeros_like(q), g, lp)

    def refresh(self, key, state, block=None):
        shape, rows, cols = draw_window(state.q.shape, block)
        v = threefry.normal(key, shape, state.q.dtype, rows, cols)
        return state._replace(u=v)

    def flip(self, state):
        return state._replace(u=-state.u)

    def velocity(self, state):
        return state.u

    def ham(self, state):
        return -state.lp + 0.5 * dim_sum(torch.sum(state.u * state.u,
                                                   dim=-1))

    def step(self, key, target, state, h_macro, delta, active):
        del key
        if self.adaptive and self.variant == "flow":
            def integrate(s, h_micro, nsteps):
                pp = PhasePoint(s.q, s.u, s.g, s.lp)
                r = masked_multistep(target, pp, -s.lp, h_micro, nsteps,
                                     None, leapfrog_step)
                out = MCState(r.state.q, r.state.v, r.state.g, r.state.lp)
                return out, torch.zeros_like(s.lp), r.all_finite, r.n_evals

            return _traj_flow_step(integrate, state, h_macro, delta, active,
                                   self.c_min, self.c_max)

        C = state.lp.shape[0]
        dtype, dev = state.q.dtype, state.q.device
        start = PhasePoint(state.q, state.u, state.g, state.lp)
        ham0 = self.ham(state)
        zf = torch.zeros((C,), dtype=dtype, device=dev)
        zi = torch.zeros((C,), dtype=torch.int32, device=dev)

        done = ~active
        out, h_out, i_f, err, cobs, nev_f = start, ham0, zi, zf, zf, zi
        c = self.c_min
        while c <= self.c_max and bool((~done).any()):
            n_f = float(1 << c)
            if self.adaptive:
                nsteps = torch.where(done, 0, 1 << c).to(torch.int32)
                h_micro = h_macro / n_f
            else:
                nsteps = (~done).to(torch.int32)
                h_micro = h_macro
            r = masked_multistep(target, start, ham0, h_micro, nsteps,
                                 None, leapfrog_step)
            e = torch.abs(r.h_end - ham0)
            accept = r.all_finite & (e < delta)
            if not self.adaptive:
                accept = torch.ones_like(accept)
            take = ~done & (accept | (c == self.c_max))
            sel = take[:, None]
            out = PhasePoint(
                q=torch.where(sel, r.state.q, out.q),
                v=torch.where(sel, r.state.v, out.v),
                g=torch.where(sel, r.state.g, out.g),
                lp=torch.where(take, r.state.lp, out.lp),
            )
            h_out = torch.where(take, r.h_end, h_out)
            i_f = torch.where(take, c, i_f)
            err = torch.where(take, r.h_end - ham0, err)
            cobs = torch.where(take, c_obs_stat(e, n_f, h_macro), cobs)
            nev_f = nev_f + r.n_evals
            done = done | take
            c += 1

        # backward Ib pass (``hamiltonian.py:139-158``)
        start_b = PhasePoint(out.q, -out.v, out.g, out.lp)
        ham_b0 = h_out
        found = ~(active & (i_f > self.c_min)) if self.adaptive else \
            torch.ones_like(active)
        max_try = i_f - 1
        i_b, nev_b = i_f, zi
        c = self.c_min
        while bool((~found & (c <= max_try)).any()):
            do = ~found & (c <= max_try)
            nsteps = torch.where(do, 1 << c, 0).to(torch.int32)
            h_micro = h_macro / float(1 << c)
            r = masked_multistep(target, start_b, ham_b0, h_micro, nsteps,
                                 None, leapfrog_step)
            accept = do & r.all_finite & (torch.abs(r.h_end - ham_b0) < delta)
            i_b = torch.where(accept, c, i_b)
            nev_b = nev_b + r.n_evals
            found = found | accept
            c += 1

        lwt = torch.where(i_b < i_f, LOG_ZERO, 0.0).to(dtype)
        lwt = torch.where(active, lwt, 0.0)
        new_state = MCState(
            q=torch.where(active[:, None], out.q, state.q),
            u=torch.where(active[:, None], out.v, state.u),
            g=torch.where(active[:, None], out.g, state.g),
            lp=torch.where(active, out.lp, state.lp),
        )
        stats = StepStats(
            n_evals=torch.where(active, nev_f + nev_b, 0),
            i_f=torch.where(active, i_f, 0),
            i_b=torch.where(active, i_b, 0),
            energy_err=torch.where(active, err, 0.0),
            c_obs=torch.where(active, cobs, 0.0),
            basic=active & (i_f == self.c_min),
        )
        return new_state, lwt, stats
