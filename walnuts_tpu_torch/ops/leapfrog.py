"""Masked multi-step symplectic integration (``walnuts_tpu/ops/leapfrog.py``).

The same dynamics as the JAX version over a chain batch ``[C, D]``:
each loop iteration performs one batched gradient evaluation for every
chain that still has micro steps left, with per-chain step counts and
micro step sizes.  Chains whose counter ran out ride along masked, and
their values are kept by ``torch.where``, never skipped.  JAX's
``lax.while_loop``s become Python loops: ``masked_multistep`` reads the
largest step count once, the implicit-midpoint solve checks ``any(~done)``
once per iteration (one host sync each).  Inside a dim split
(:mod:`..parallel.mesh`) the per-chain errors and magnitudes are maxima
over the dim group, so the ranks that share a chain stop together.
"""

from typing import NamedTuple

import torch

from ..parallel.mesh import NEWTON_DIM_SPLIT_ITEM, current_dim_split, dim_max
from .hamiltonian import hamiltonian

# Host syncs made by the implicit-midpoint solve's loop test (``bool(
# any(~done))``) since the caller last set it to 0: one per fixed-point
# iteration, and one more where the loop ends on convergence rather
# than at ``max_fp_iter``.
fixed_point_syncs = 0

# 4th-order Yoshida composition coefficients
# (reference ``adaptiveIntegrators.py:143-144``).
YOSHIDA_W1 = 1.351207191959658
YOSHIDA_W2 = -1.702414383919315


class PhasePoint(NamedTuple):
    """A batch of phase-space points in integration orientation."""

    q: torch.Tensor    # [C, D] position
    v: torch.Tensor    # [C, D] velocity (already xi-oriented)
    g: torch.Tensor    # [C, D] gradient of logp at q
    lp: torch.Tensor   # [C]    logp at q


class MultistepResult(NamedTuple):
    state: PhasePoint
    h_end: torch.Tensor        # [C] Hamiltonian at the final state
    max_dh: torch.Tensor       # [C] max |H_k - H_{k-1}| over executed steps
    max_step_err: torch.Tensor  # [C] max per-step flow-error estimate
    all_finite: torch.Tensor   # [C] bool: finite energies AND every step ok
    n_evals: torch.Tensor      # [C] int32 gradient evals actually performed


def _true(hh):
    return torch.ones(hh.shape, dtype=torch.bool, device=hh.device)


def leapfrog_step(target, state: PhasePoint, hh, inv_mass=None):
    """One velocity-Verlet micro step; one gradient evaluation.

    ``hh`` is per-chain ``[C]``.  Step functions return ``(state, err,
    ok, nev)``: a per-step flow-error estimate, per-chain step success
    and the per-chain gradient evaluations (an int or a ``[C]`` tensor).
    """
    h = hh[:, None]
    vh = state.v + 0.5 * h * state.g
    dq = vh if inv_mass is None else inv_mass * vh
    q2 = state.q + h * dq
    lp2, g2 = target.logp_grad(q2)
    v2 = vh + 0.5 * h * g2
    return PhasePoint(q2, v2, g2, lp2), torch.zeros_like(hh), _true(hh), 1


def yoshida_step(target, state: PhasePoint, hh, inv_mass=None):
    """One 4th-order 3-stage Yoshida step; three gradient evaluations
    (reference ``adaptiveIntegrators.py:156-175``)."""
    s = state
    for w in (YOSHIDA_W1, YOSHIDA_W2, YOSHIDA_W1):
        s, _, _, _ = leapfrog_step(target, s, w * hh, inv_mass)
    return s, torch.zeros_like(hh), _true(hh), 3


def leapfrog_flow_step(target, state: PhasePoint, hh, inv_mass=None):
    """Leapfrog step plus the Hermite forward/backward flow-error
    estimate: two gradient evaluations, one at the endpoint and one at
    the reconstructed midpoint (reference ``adaptiveIntegrators.py:260-287``)."""
    h = hh[:, None]
    q_old, v_old, g_old = state.q, state.v, state.g
    new, _, _, _ = leapfrog_step(target, state, hh, inv_mass)
    q2, v2, g2 = new.q, new.v, new.g

    q_mid = 0.5 * (q2 + q_old) + (h / 8.0) * (v_old - v2)
    _, g_mid = target.logp_grad(q_mid)

    qf = q_old + h * v_old + h * h * (g_old / 6.0 + g_mid / 3.0)
    err = torch.amax(torch.abs(qf - q2), dim=-1)
    vf = v_old + (h / 6.0) * (g_old + g2 + 4.0 * g_mid)
    err = torch.maximum(err, torch.amax(torch.abs(vf - v2), dim=-1))
    qb = q2 - h * v2 + h * h * (g2 / 6.0 + g_mid / 3.0)
    err = torch.maximum(err, torch.amax(torch.abs(qb - q_old), dim=-1))
    vb = -(-v2 + (h / 6.0) * (g_old + g2 + 4.0 * g_mid))
    err = torch.maximum(err, torch.amax(torch.abs(vb - v_old), dim=-1))
    return new, dim_max(err), _true(hh), 2


def implicit_midpoint_step(target, state: PhasePoint, hh, inv_mass=None, *,
                           fp_tol=1.0e-8, max_fp_iter=30, newton=False):
    """One implicit-midpoint micro step solved by fixed-point (or
    Newton) iteration (reference ``adaptiveIntegrators.py:492-540``).

    Solves ``q2 = q + h v + (h^2/2) M^{-1} g((q + q2)/2)`` from a
    leapfrog guess.  Iteration stops per chain on convergence
    (``max|dq| < fp_tol``) or divergence (``err > 1.1 * prev_err``); a
    chain whose step fails returns ``ok=False`` and a ``-inf`` density.
    The tolerance is floored at ``32 eps max(max|q|, 1)`` of the working
    dtype, so float32 chains can converge.  Newton mode solves with the
    batched target Hessian (a dense ``[D, D]`` per chain, which a dim
    split does not take: it raises, naming ``NEWTON_DIM_SPLIT_ITEM``).
    """
    if newton and current_dim_split() is not None:
        raise NotImplementedError(
            "the implicit midpoint's Newton mode solves with each chain's "
            f"whole Hessian; under a dim split it waits for "
            f"{NEWTON_DIM_SPLIT_ITEM}")
    h = hh[:, None]
    qq, vv, gg = state.q, state.v, state.g
    scale = 1.0 if inv_mass is None else inv_mass
    base = qq + h * (scale * vv)
    qt = base + 0.5 * h * h * (scale * gg)  # leapfrog guess
    eps = torch.finfo(qq.dtype).eps
    q_mag = torch.clamp(dim_max(torch.amax(torch.abs(qq), dim=-1)), min=1.0)
    fp_tol = torch.maximum(torch.tensor(fp_tol, dtype=qq.dtype,
                                        device=qq.device), 32.0 * eps * q_mag)

    done = torch.zeros(hh.shape, dtype=torch.bool, device=hh.device)
    conv = torch.zeros_like(done)
    old_err = torch.full_like(hh, 1.0e30)
    nev = torch.zeros(hh.shape, dtype=torch.int32, device=hh.device)
    it = 0
    while it < max_fp_iter and bool((~done).any()):
        mid = 0.5 * (qt + qq)
        gmp = target.logp_grad(mid)[1]
        if newton:
            hess = target.hessian_batched(mid)
            eye = torch.eye(qq.shape[-1], dtype=qt.dtype, device=qt.device)
            hh2 = (0.25 * h * h)[..., None] * (
                hess if inv_mass is None else inv_mass[:, None] * hess) - eye
            resid = base + 0.5 * h * h * (scale * gmp) - qt
            qt_new = qt - torch.linalg.solve(hh2, resid[..., None])[..., 0]
        else:
            qt_new = base + 0.5 * h * h * (scale * gmp)
        err = dim_max(torch.amax(torch.abs(qt_new - qt), dim=-1))
        qt = torch.where(done[:, None], qt, qt_new)
        newly_conv = ~done & (err < fp_tol)
        diverged = ~done & (err > 1.1 * old_err)
        conv = conv | newly_conv
        old_err = torch.where(done, old_err, err)
        nev = nev + (~done).to(torch.int32)
        done = done | newly_conv | diverged
        it += 1
    global fixed_point_syncs
    fixed_point_syncs += it + (it < max_fp_iter)

    # final midpoint evaluation at the converged qt, then the update
    # (reference ``adaptiveIntegrators.py:528-540``)
    mid = 0.5 * (qt + qq)
    gmp = target.logp_grad(mid)[1]
    q2 = base + 0.5 * h * h * (scale * gmp)
    v2 = vv + h * gmp
    lp2, g2 = target.logp_grad(q2)
    lp2 = torch.where(conv, lp2, -torch.inf)
    return PhasePoint(q2, v2, g2, lp2), torch.zeros_like(hh), conv, nev + 2


STEP_FNS = {
    "leapfrog": leapfrog_step,
    "yoshida": yoshida_step,
    "leapfrog_flow": leapfrog_flow_step,
    "implicit_midpoint": implicit_midpoint_step,
}


def masked_multistep(target, state: PhasePoint, h0_energy, h_micro, nsteps,
                     inv_mass=None, step_fn=leapfrog_step):
    """Advance each chain ``nsteps[c]`` micro steps of size ``h_micro[c]``.

    Runs ``max(nsteps)`` batched iterations (one host read of that
    maximum); chains with fewer steps freeze in place once their counter
    is exhausted, and ``nsteps == 0`` chains pass through untouched.
    """
    s = state
    h_end = h0_energy
    max_dh = torch.zeros_like(h0_energy)
    max_err = torch.zeros_like(h0_energy)
    finite = torch.ones(h0_energy.shape, dtype=torch.bool,
                        device=h0_energy.device)
    nev = torch.zeros(h0_energy.shape, dtype=torch.int32,
                      device=h0_energy.device)
    n_iter = int(nsteps.max()) if nsteps.numel() else 0
    for k in range(n_iter):
        active = k < nsteps
        s_new, err, ok, nev_k = step_fn(
            target, s, torch.where(active, h_micro, 0.0), inv_mass)
        h_new = hamiltonian(s_new.lp, s_new.v, inv_mass)
        dh = torch.abs(h_new - h_end)
        a1 = active[:, None]
        s = PhasePoint(
            q=torch.where(a1, s_new.q, s.q),
            v=torch.where(a1, s_new.v, s.v),
            g=torch.where(a1, s_new.g, s.g),
            lp=torch.where(active, s_new.lp, s.lp),
        )
        h_end = torch.where(active, h_new, h_end)
        max_dh = torch.where(active, torch.maximum(max_dh, dh), max_dh)
        max_err = torch.where(active, torch.maximum(max_err, err), max_err)
        finite = torch.where(active, finite & ok & torch.isfinite(h_new),
                             finite)
        nev = nev + torch.where(active, torch.as_tensor(
            nev_k, dtype=torch.int32, device=nev.device), 0)
    return MultistepResult(s, h_end, max_dh, max_err, finite, nev)
