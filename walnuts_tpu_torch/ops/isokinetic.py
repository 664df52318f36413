"""Isokinetic (microcanonical) dynamics over a chain batch
(``walnuts_tpu/ops/isokinetic.py``).

The state carries a unit-sphere velocity ``u`` (:class:`MCState`).  One
micro step is the exact B(h/2)-A(h)-B(h/2) splitting whose B-kick is
the closed-form isokinetic flow along the score direction (``cosh`` /
``sinh`` with normaliser ``Z``), accumulating the log-Jacobian ``W +=
(d-1) log Z``.  A kick whose rapidity exceeds ``ISOKINETIC_DELTA_THRESH``
or whose ``Z`` falls below 1e-14 clears the chain's ``ok`` flag, and the
orbit layer weights the state to log-zero.  The adaptive step functions
are halving searches on the modified energy (``adapt_mc_step_e``) or on
an Euler-comparison flow error (``adapt_mc_step_flow2``), each with a
backward ``Ib`` pass.

Semantics and operation order are the JAX version's.  Its
``lax.while_loop``s become host loops: a multistep reads the largest
step count once, a refinement search checks ``any`` once per level (one
host sync each), as :func:`..ops.leapfrog.masked_multistep` does.
Norms are ``sqrt(sum(x * x))``, as ``jnp.linalg.norm`` computes them.
The step functions take the JAX version's unused ``key`` as their first
argument, so that the step kernels can pass one.

Inside a dim split (:func:`..parallel.mesh.dim_split`) the batch holds
this rank's columns: every norm and dot over D is the dim group's sum,
the flow error's maximum the group's maximum, a draw over D the rank's
window of the whole draw, and the dimension in the kick's ``d - 1`` and
the partial refresh's ``sqrt(d)`` is the whole D.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.mesh import col_window, dim_max, dim_sum
from ..utils import threefry
from ..utils.constants import ISOKINETIC_DELTA_THRESH, LOG_ZERO


class MCState(NamedTuple):
    """Batched isokinetic phase point: unit velocity, cached density."""

    q: torch.Tensor    # [C, D]
    u: torch.Tensor    # [C, D], ||u|| = 1 per chain
    g: torch.Tensor    # [C, D]
    lp: torch.Tensor   # [C]

    @property
    def ham(self):
        """The isokinetic 'Hamiltonian' is just ``-logp``."""
        return -self.lp


class StepStats(NamedTuple):
    """Per-macro-step diagnostics of an adaptive step kernel."""

    n_evals: torch.Tensor     # [C] int32
    i_f: torch.Tensor         # [C] int32
    i_b: torch.Tensor         # [C] int32
    energy_err: torch.Tensor  # [C] signed modified-energy error
    c_obs: torch.Tensor       # [C] |err| * nstep^2 / h^3 (warmup stat)
    basic: torch.Tensor       # [C] bool: If == c_min (no backward pass)


class IsoMultistepResult(NamedTuple):
    state: MCState
    log_jac: torch.Tensor    # [C] accumulated W
    all_ok: torch.Tensor     # [C] bool
    n_evals: torch.Tensor    # [C] int32


def _norm(x, keepdim=False):
    return torch.sqrt(dim_sum(torch.sum(x * x, dim=-1, keepdim=keepdim)))


def mcstate_from_numpy(d, device="cpu") -> MCState:
    """An :class:`MCState` from a mapping of its fields to arrays (a JAX
    ``MCState``'s ``_asdict()`` through ``np.asarray``), on ``device``."""
    return MCState(*(torch.from_numpy(np.array(d[f])).to(device)
                     for f in MCState._fields))


def mcstate_to_numpy(st: MCState) -> dict:
    """The fields of ``st`` as numpy arrays (the inverse of
    :func:`mcstate_from_numpy`)."""
    return {f: getattr(st, f).detach().cpu().numpy() for f in MCState._fields}


def draw_window(shape, block=None):
    """``(global shape, rows, cols)`` of a draw for a ``shape`` batch
    that is rows ``c0 .. c0+C-1`` of ``C_total`` chains (``block = (c0,
    C_total)``; ``rows`` None without one) and, for a ``[C, ..., D]``
    batch inside a dim split, the rank's columns ``cols`` of the whole
    width (:func:`..parallel.mesh.col_window`; None without one)."""
    shape, rows, cols = tuple(shape), None, None
    if block is not None:
        c0, C_total = block
        shape, rows = (C_total,) + shape[1:], (c0, c0 + shape[0])
    if len(shape) >= 2:
        D, cols = col_window(shape[-1])
        shape = shape[:-1] + (D,)
    return shape, rows, cols


def refresh_u(key, shape, dtype=torch.float32, rows=None, cols=None):
    """Full momentum refresh from the threefry key ``key``: ``u``
    uniform on the unit sphere (``rows=(r0, r1)`` and ``cols=(c0, c1)``:
    that window of ``shape``'s leading and last axes alone, as in
    :func:`..utils.threefry.normal`)."""
    p = threefry.normal(key, shape, dtype, rows, cols)
    return p / _norm(p, keepdim=True)


def partial_refresh_u(key, u, c1, block=None):
    """Partial refresh mixing the old direction with a fresh normal
    draw (``microCanonical.py:34-38``); ``block = (c0, C_total)`` when
    ``u`` holds rows ``c0 ..`` of a batch of ``C_total``."""
    shape, rows, cols = draw_window(u.shape, block)
    z = threefry.normal(key, shape, u.dtype, rows, cols)
    z = z / torch.sqrt(torch.tensor(shape[-1], dtype=u.dtype,
                                    device=u.device))
    t = c1 * u + float(np.sqrt(1.0 - c1 ** 2)) * z
    return t / _norm(t, keepdim=True)


def _b_kick(u, g, h_half, d):
    """Exact isokinetic B-kick over time ``h_half`` along the score
    direction; returns ``(u_new, dW, ok)``.

    The rapidity is clipped at ``ISOKINETIC_DELTA_THRESH`` (and the step
    marked failed) as in JAX; float32's ``cosh`` overflows there all the
    same, so such a chain's ``u`` comes out non-finite in float32, as in
    JAX.  The zero-gradient guard ``max(|g|, 1e-300)`` is 0 in float32,
    where a zero gradient therefore gives NaN, again as in JAX."""
    gnorm = _norm(g)
    delta = h_half * gnorm / (d - 1.0)
    ok = delta <= ISOKINETIC_DELTA_THRESH
    delta = torch.clamp(delta, 0.0, ISOKINETIC_DELTA_THRESH)
    e = g / torch.clamp(gnorm, min=1e-300)[:, None]
    ep = dim_sum(torch.sum(e * u, dim=-1))
    ch, sh = torch.cosh(delta), torch.sinh(delta)
    z = ch + ep * sh
    ok = ok & (z >= 1.0e-14)
    zs = torch.clamp(z, min=1.0e-14)
    d_w = (d - 1.0) * torch.log(zs)
    u_new = u / zs[:, None] + ((sh + ep * (ch - 1.0)) / zs)[:, None] * e
    # re-project onto the sphere against roundoff (``bab_isokinetic.m:47``)
    u_new = u_new / _norm(u_new, keepdim=True)
    return u_new, d_w, ok


def _bab(target, s: MCState, hh, d):
    """One B-A-B micro step of size ``hh`` [C] from every chain."""
    h_half = 0.5 * hh
    u1, dw1, ok1 = _b_kick(s.u, s.g, h_half, d)
    q2 = s.q + hh[:, None] * u1
    lp2, g2 = target.logp_grad(q2)
    u2, dw2, ok2 = _b_kick(u1, g2, h_half, d)
    ok = ok1 & ok2 & torch.isfinite(lp2)
    return u1, q2, lp2, g2, u2, dw1 + dw2, ok


def _iso_loop(target, state: MCState, h_micro, nsteps, with_err):
    d = float(col_window(state.q.shape[-1])[0])
    s = state
    C = state.lp.shape[0]
    dtype, dev = state.q.dtype, state.q.device
    w = torch.zeros((C,), dtype=dtype, device=dev)
    all_ok = torch.ones((C,), dtype=torch.bool, device=dev)
    nev = torch.zeros((C,), dtype=torch.int32, device=dev)
    eq = eu = torch.zeros_like(state.q)
    n_iter = int(nsteps.max()) if nsteps.numel() else 0
    for k in range(n_iter):
        active = k < nsteps
        hh = torch.where(active, h_micro, 0.0)
        h1 = hh[:, None]
        if with_err:
            # forward Euler references (``microCanonical.py:148-152``)
            gu = dim_sum(torch.sum(s.g * s.u, dim=-1))[:, None]
            eul_q = s.q + h1 * s.u
            eul_u = s.u + (h1 / (d - 1.0)) * (s.g - gu * s.u)
            eul_u = eul_u / _norm(eul_u, keepdim=True)
        _, q2, lp2, g2, u2, dw, ok = _bab(target, s, hh, d)
        a1 = active[:, None]
        if with_err:
            # error contributions (``microCanonical.py:186-199``)
            err_qf = torch.abs(q2 - eul_q)
            err_uf = torch.abs(u2 - eul_u)
            err_qb = torch.abs(s.q - (q2 - h1 * u2))
            gu2 = dim_sum(torch.sum(g2 * u2, dim=-1))[:, None]
            uback = -u2 + (h1 / (d - 1.0)) * (g2 - gu2 * u2)
            uback = uback / _norm(uback, keepdim=True)
            err_ub = torch.abs(-s.u - uback)
            eq = eq + torch.where(a1, torch.maximum(err_qf, err_qb), 0.0)
            eu = eu + torch.where(a1, torch.maximum(err_uf, err_ub), 0.0)
        s = MCState(q=torch.where(a1, q2, s.q), u=torch.where(a1, u2, s.u),
                    g=torch.where(a1, g2, s.g),
                    lp=torch.where(active, lp2, s.lp))
        w = w + torch.where(active, dw, 0.0)
        all_ok = torch.where(active, all_ok & ok, all_ok)
        nev = nev + active.to(torch.int32)
    res = IsoMultistepResult(s, w, all_ok, nev)
    if not with_err:
        return res
    err = dim_max(torch.maximum(torch.amax(eq, dim=-1),
                                torch.amax(eu, dim=-1)))
    return res, err


def isokinetic_multistep(target, state: MCState, h_micro, nsteps):
    """Advance each chain ``nsteps[c]`` B-A-B micro steps of size
    ``h_micro[c]``, accumulating the log-Jacobian ``W``.  Chains with
    ``nsteps == 0`` pass through untouched; guard violations clear
    ``all_ok``.  Runs ``max(nsteps)`` batched iterations (one host read
    of that maximum)."""
    return _iso_loop(target, state, h_micro, nsteps, False)


def isokinetic_multistep_err(target, state: MCState, h_micro, nsteps):
    """B-A-B multistep with the per-step Euler-comparison flow-error
    estimate (``integrateSplittingErrEst``): each step accumulates the
    elementwise max of forward and backward Euler reconstruction
    discrepancies in position and velocity; the scalar error is the max
    over coordinates of the accumulated sums.

    Returns ``(IsoMultistepResult, err_est)``."""
    return _iso_loop(target, state, h_micro, nsteps, True)


def c_obs_stat(err, n_f, h_macro):
    """The warmup statistic ``|err| * n^2 / h^3`` of a step accepted at
    ``n_f`` (a float power of two) micro steps, in JAX's order (``x**2``
    and ``x**3`` are repeated products there; ``n^2`` is exact).  The
    step counts are host floats, so no scalar tensor is copied to the
    card per refinement level."""
    return torch.abs(err) * (n_f * n_f) / (h_macro * h_macro * h_macro)


def where_state(mask, a: MCState, b: MCState) -> MCState:
    """Per chain, ``a`` where ``mask`` [C] holds, else ``b``."""
    m1 = mask[:, None]
    return MCState(torch.where(m1, a.q, b.q), torch.where(m1, a.u, b.u),
                   torch.where(m1, a.g, b.g), torch.where(mask, a.lp, b.lp))


def fixed_mc_step(key, target, state: MCState, h_macro, delta, active,
                  c_min=0, c_max=10):
    """Single B-A-B step, no adaptation (``fixedMCstep``)."""
    del key, delta, c_min, c_max
    nsteps = active.to(torch.int32)
    r = isokinetic_multistep(target, state, h_macro, nsteps)
    lwt = torch.where(r.all_ok, -r.log_jac, LOG_ZERO)
    zi = torch.zeros_like(r.n_evals)
    stats = StepStats(r.n_evals, zi, zi, torch.zeros_like(h_macro),
                      torch.zeros_like(h_macro),
                      torch.ones(active.shape, dtype=torch.bool,
                                 device=active.device))
    return r.state, lwt, stats


def _halving(target, state: MCState, h_macro, delta, active, c_min, c_max,
             flow):
    """The forward search of ``adapt_mc_step_e`` (``flow=False``, error
    ``|loc_acc|``) and ``adapt_mc_step_flow2`` (``flow=True``, the
    Euler-comparison estimate); both record ``loc_acc``."""
    C = state.lp.shape[0]
    dtype, dev = state.q.dtype, state.q.device
    ham0 = state.ham
    zf = torch.zeros((C,), dtype=dtype, device=dev)
    zi = torch.zeros((C,), dtype=torch.int32, device=dev)
    done = ~active
    out, w_out = state, zf
    ok_out = torch.ones((C,), dtype=torch.bool, device=dev)
    i_f, e_acc, cobs, nev = zi, zf, zf, zi
    c = c_min
    while c <= c_max and bool((~done).any()):
        nsteps = torch.where(done, 0, 1 << c).to(torch.int32)
        n_f = float(1 << c)
        h_micro = h_macro / n_f
        if flow:
            r, err = isokinetic_multistep_err(target, state, h_micro, nsteps)
        else:
            r = isokinetic_multistep(target, state, h_micro, nsteps)
        loc_acc = -r.state.ham - r.log_jac + ham0
        if not flow:
            err = torch.abs(loc_acc)
        accept = r.all_ok & (err < delta)
        take = ~done & (accept | (c == c_max))
        out = where_state(take, r.state, out)
        w_out = torch.where(take, r.log_jac, w_out)
        ok_out = torch.where(take, r.all_ok, ok_out)
        i_f = torch.where(take, c, i_f)
        e_acc = torch.where(take, loc_acc, e_acc)
        cobs = torch.where(take, c_obs_stat(loc_acc, n_f, h_macro), cobs)
        nev = nev + r.n_evals
        done = done | take
        c += 1
    return out, w_out, ok_out, i_f, e_acc, cobs, nev


def _backward(target, out: MCState, h_macro, delta, active, i_f, c_min,
              max_try, flow):
    """The ``Ib`` search from the flipped endpoint: the first level up to
    ``max_try`` (per chain, inclusive) whose trial is accepted."""
    C = out.lp.shape[0]
    ham_b0 = out.ham
    state_b = MCState(out.q, -out.u, out.g, out.lp)
    found = ~(active & (i_f > c_min))
    i_b = i_f
    nev = torch.zeros((C,), dtype=torch.int32, device=out.q.device)
    c = c_min
    while bool((~found & (c <= max_try)).any()):
        do = ~found & (c <= max_try)
        nsteps = torch.where(do, 1 << c, 0).to(torch.int32)
        h_micro = h_macro / float(1 << c)
        if flow:
            r, err = isokinetic_multistep_err(target, state_b, h_micro,
                                              nsteps)
        else:
            r = isokinetic_multistep(target, state_b, h_micro, nsteps)
            err = torch.abs(-r.state.ham - r.log_jac + ham_b0)
        accept = do & r.all_ok & (err < delta)
        i_b = torch.where(accept, c, i_b)
        nev = nev + r.n_evals
        found = found | accept
        c += 1
    return i_b, nev


def _finish(state, out, w_out, ok_out, i_f, i_b, e_acc, cobs, nev, active,
            c_min):
    lwt = -w_out + torch.where(i_b < i_f, LOG_ZERO, 0.0)
    lwt = torch.where(ok_out, lwt, LOG_ZERO)
    lwt = torch.where(active, lwt, 0.0)
    stats = StepStats(
        n_evals=torch.where(active, nev, 0),
        i_f=torch.where(active, i_f, 0),
        i_b=torch.where(active, i_b, 0),
        energy_err=torch.where(active, e_acc, 0.0),
        c_obs=torch.where(active, cobs, 0.0),
        basic=active & (i_f == c_min),
    )
    return where_state(active, out, state), lwt, stats


def adapt_mc_step_flow2(key, target, state: MCState, h_macro, delta, active,
                        c_min=0, c_max=10):
    """Flow-error halving search using the Euler-comparison estimate
    (``adaptMCstepFlow2``): the first refinement whose accumulated
    flow-error estimate is below ``delta`` is ``If``; the backward pass
    searches ``c_min..If`` inclusive from the flipped endpoint; weight
    ``-W`` with a hard ``LOG_ZERO`` when ``Ib < If``."""
    del key
    out, w_out, ok_out, i_f, e_acc, cobs, nev_f = _halving(
        target, state, h_macro, delta, active, c_min, c_max, True)
    i_b, nev_b = _backward(target, out, h_macro, delta, active, i_f, c_min,
                           i_f, True)
    return _finish(state, out, w_out, ok_out, i_f, i_b, e_acc, cobs,
                   nev_f + nev_b, active, c_min)


def adapt_mc_step_e(key, target, state: MCState, h_macro, delta, active,
                    c_min=0, c_max=10):
    """Energy-error halving search over the isokinetic integrator
    (``adaptMCstepE.__call__``).

    Returns ``(new_state, lwt, stats)`` where ``lwt = -W`` plus a hard
    ``LOG_ZERO`` when the backward minimal refinement ``Ib`` is below
    the forward one."""
    del key
    out, w_out, ok_out, i_f, e_acc, cobs, nev_f = _halving(
        target, state, h_macro, delta, active, c_min, c_max, False)
    i_b, nev_b = _backward(target, out, h_macro, delta, active, i_f, c_min,
                           i_f - 1, False)
    return _finish(state, out, w_out, ok_out, i_f, i_b, e_acc, cobs,
                   nev_f + nev_b, active, c_min)
