"""Paper-pseudocode WALNUTS (``walnuts_tpu/sampler/pseudocode.py``).

The reference's clean pseudocode implementation
(``walnuts/walnuts.py:16-408``) as a chain-batched torch program.  It
differs from the instrumented engine (:mod:`.transition`) as the
reference's two implementations differ:

* a diagonal inverse-mass metric everywhere (momentum refresh, kinetic
  energy, U-turn metric);
* ``stable_steps``: the smallest ``ell = 2^n, n <= max_n`` whose macro
  step keeps the max-min range of the Hamiltonian within
  ``max_error``;
* micro-step randomisation ``uniform_3``: ``ell ~ U{ell/2, ell, 2
  ell}`` with its pmf in the Hastings correction;
* whole-subtree extension per depth (``2^depth`` macro steps), an
  iterative power-of-2-span sub-U-turn scan over the new segment, and
  biased subtree acceptance with softmax (Gumbel-max) selection inside
  the accepted subtree.

Both documented deviations of the JAX version are kept:

1. backward-generated states store time-oriented momenta, flipped
   exactly once per backward leg (the reference flips on every backward
   extension and so retraces the orbit);
2. ``choose_micro_steps`` floors the ``uniform_3`` support at 1 (the
   reference draws 0 steps when ``ell_stable == 1``); the matching pmf
   gives the collapsed support ``{1, 2}`` the probabilities ``{2/3,
   1/3}``.

Every random draw keeps the JAX version's key path, from the port's
threefry stream (:mod:`..utils.threefry`, with JAX's x64 word widths),
so the two agree draw for draw.  JAX's masked ``while_loop``s become
host loops on ``any()``, its ``scan``s Python loops.
``walnuts_step_pseudo`` runs on its inputs' device; ``walnuts_pseudo``
runs on the card unless the caller passes ``device="cpu"``.
"""

import math
from typing import NamedTuple

import torch

from ..ops.hamiltonian import hamiltonian, refresh_momentum, uturn
from ..ops.leapfrog import PhasePoint, leapfrog_step
from ..utils import threefry
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .generic_nuts import logaddexp

_LOG3 = math.log(3.0)


class PseudoResult(NamedTuple):
    q: torch.Tensor              # [C, D] selected positions
    n_grad: torch.Tensor         # [C] gradient evaluations this transition
    depth_stopped: torch.Tensor  # [C] depth at which expansion stopped


def _masked_steps(target, s, h_micro, nsteps, inv_mass, track_range):
    """``nsteps[c]`` leapfrog micro steps of ``h_micro[c]``; with
    ``track_range``, the min and max Hamiltonian over every state
    (``walnuts.py:74-95,160-178``).  One host read of ``max(nsteps)``."""
    h_min = h_max = hamiltonian(s.lp, s.v, inv_mass) if track_range else None
    nev = torch.zeros(s.lp.shape, dtype=torch.int32, device=s.lp.device)
    for k in range(int(nsteps.max()) if nsteps.numel() else 0):
        active = k < nsteps
        s2, _, _, _ = leapfrog_step(
            target, s, torch.where(active, h_micro, 0.0), inv_mass)
        a1 = active[:, None]
        s = PhasePoint(q=torch.where(a1, s2.q, s.q),
                       v=torch.where(a1, s2.v, s.v),
                       g=torch.where(a1, s2.g, s.g),
                       lp=torch.where(active, s2.lp, s.lp))
        if track_range:
            h_cur = hamiltonian(s2.lp, s2.v, inv_mass)
            h_min = torch.where(active, torch.minimum(h_min, h_cur), h_min)
            h_max = torch.where(active, torch.maximum(h_max, h_cur), h_max)
        nev = nev + active.to(torch.int32)
    return s, h_min, h_max, nev


def stable_steps(target, q, rho, inv_mass, macro_step, max_error, active,
                 max_n: int = 10):
    """Smallest ``ell = 2^n`` bounding the Hamiltonian range
    (``walnuts.py:144-182``).  Returns ``(success, ell, n_grad)``."""
    C = q.shape[0]
    dev = q.device
    done = ~active
    success = torch.zeros((C,), dtype=torch.bool, device=dev)
    ell = torch.ones((C,), dtype=torch.int32, device=dev)
    nev = torch.zeros((C,), dtype=torch.int32, device=dev)
    lp, g = target.logp_grad(q)
    n = 0
    while n <= max_n and bool((~done).any()):
        ell_try = 1 << n
        nsteps = torch.where(done, 0, ell_try).to(torch.int32)
        h_micro = macro_step / float(ell_try)
        _, h_min, h_max, nev_k = _masked_steps(
            target, PhasePoint(q, rho, g, lp), h_micro, nsteps, inv_mass,
            True)
        ok = torch.isfinite(h_max) & (h_max - h_min <= max_error)
        take = ~done & (ok | (n == max_n))
        success = torch.where(take, ok, success)
        ell = torch.where(take, ell_try, ell)
        done = done | take
        nev = nev + nev_k
        n += 1
    return success, ell, nev


def choose_micro_steps(key, ell_stable, policy: str = "uniform_3"):
    """Draw the simulated micro-step count around ``ell_stable``:
    ``"uniform_3"`` draws ``ell ~ U{ell/2, ell, 2 ell}`` floored at 1,
    ``"shifted_23"`` draws ``{ell, 2 ell}`` at ``(2/3, 1/3)`` (the
    MATLAB line's scheme)."""
    if policy == "uniform_3":
        r = threefry.randint(key, ell_stable.shape, 0, 3).to(
            ell_stable.device)
        return torch.where(r == 0, torch.clamp(ell_stable // 2, min=1),
                           torch.where(r == 1, ell_stable, 2 * ell_stable))
    if policy == "shifted_23":
        coarse = threefry.uniform(key, ell_stable.shape) < 2.0 / 3.0
        return torch.where(coarse, ell_stable, 2 * ell_stable)
    raise ValueError(f"unknown micro-step policy {policy!r}")


def micro_steps_logp(ell, ell_stable, policy: str = "uniform_3"):
    """log pmf matching :func:`choose_micro_steps`
    (``walnuts.py:199-208``), float64."""
    f64 = dict(dtype=torch.float64, device=ell.device)
    log23 = torch.log(torch.tensor(2.0 / 3.0, **f64))
    if policy == "uniform_3":
        lo = torch.clamp(ell_stable // 2, min=1)
        in_support = ((ell == lo) | (ell == ell_stable)
                      | (ell == 2 * ell_stable))
        collapsed = lo == ell_stable  # ell_stable == 1
        p = torch.where(collapsed & (ell == ell_stable), log23,
                        torch.tensor(-_LOG3, **f64))
        return torch.where(in_support, p, -math.inf)
    if policy == "shifted_23":
        p = torch.where(ell == ell_stable, log23,
                        torch.log(torch.tensor(1.0 / 3.0, **f64)))
        in_support = (ell == ell_stable) | (ell == 2 * ell_stable)
        return torch.where(in_support, p, -math.inf)
    raise ValueError(f"unknown micro-step policy {policy!r}")


def _logsumexp(a, dim):
    """``jax.scipy.special.logsumexp``: shifted by the maximum where it
    is finite, by 0 otherwise."""
    amax = torch.amax(a, dim=dim)
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    return torch.log(torch.sum(torch.exp(a - amax.unsqueeze(dim)),
                               dim=dim)) + amax


def walnuts_step_pseudo(key, q, *, target, inv_mass, macro_step,
                        max_depth: int = 10, max_error=0.1, max_n: int = 10,
                        micro_policy: str = "uniform_3"):
    """One paper-mode WALNUTS transition for a ``[C, D]`` batch
    (``walnuts_step``, ``walnuts.py:279-359``), on ``q``'s device.
    ``key`` is a threefry key."""
    C, D = q.shape
    dtype, dev = q.dtype, q.device
    key = key.to(dev)
    inv_mass = torch.as_tensor(inv_mass, dtype=dtype, device=dev).expand(D)
    macro = torch.as_tensor(macro_step, dtype=dtype, device=dev).expand(C)
    max_err = torch.as_tensor(max_error, dtype=dtype, device=dev)
    rows = torch.arange(C, device=dev)

    k_mom, k_loop = threefry.split(key)
    rho0 = refresh_momentum(k_mom, (C, D), inv_mass, dtype)
    lp0, g0 = target.logp_grad(q)
    lw0 = -hamiltonian(lp0, rho0, inv_mass)

    # carried endpoint states (time-oriented momenta; deviation 1)
    qp, rhop, gp, lpp = q, rho0, g0, lp0
    qm, rhom, gm, lpm = q, rho0, g0, lp0
    q_sel = q
    log_w_old = lw0          # logsumexp of the accepted orbit's weights
    w_end_f = lw0            # log weight of the forward end state
    w_end_b = lw0
    done = torch.zeros((C,), dtype=torch.bool, device=dev)
    n_grad = torch.zeros((C,), dtype=torch.int32, device=dev)
    depth_stop = torch.full((C,), max_depth, dtype=torch.int32, device=dev)
    W = torch.where

    for depth in range(max_depth):
        n_steps = 2 ** depth
        k_depth = threefry.fold_in(k_loop, depth)
        k_dir, k_acc, k_pick, k_scan = threefry.split(k_depth, 4)
        backward = threefry.bernoulli(k_dir, 0.5, (C,))
        active = ~done
        b1 = backward[:, None]

        # the extension's start, momentum oriented in the direction of
        # travel
        q_e, rho_e = W(b1, qm, qp), W(b1, -rhom, rhop)
        g_e, lp_e = W(b1, gm, gp), W(backward, lpm, lpp)
        w_e = W(backward, w_end_b, w_end_f)
        nev = torch.zeros((C,), dtype=torch.int32, device=dev)
        seg_q, seg_rho, seg_w = [], [], []
        for j in range(n_steps):
            k_ell = threefry.fold_in(threefry.fold_in(k_scan, j), 0)
            h_here = hamiltonian(lp_e, rho_e, inv_mass)
            _, ell_st, nev1 = stable_steps(
                target, q_e, rho_e, inv_mass, macro, max_err, active, max_n)
            ell = choose_micro_steps(k_ell, ell_st, micro_policy)
            s, _, _, nev2 = _masked_steps(
                target, PhasePoint(q_e, rho_e, g_e, lp_e),
                macro / ell.to(dtype), W(active, ell, 0), inv_mass, False)
            _, ell_st_next, nev3 = stable_steps(
                target, s.q, -s.v, inv_mass, macro, max_err, active, max_n)
            h_next = hamiltonian(s.lp, s.v, inv_mass)
            w_e = w_e + W(
                active,
                (-h_next) - (-h_here)
                + micro_steps_logp(ell, ell_st_next, micro_policy).to(dtype)
                - micro_steps_logp(ell, ell_st, micro_policy).to(dtype),
                0.0)
            # non-finite Hamiltonians poison the weight, not the carry
            w_e = W(torch.isnan(w_e), -math.inf, w_e)
            nev = nev + nev1 + nev2 + nev3
            q_e, rho_e, g_e, lp_e = s.q, s.v, s.g, s.lp
            seg_q.append(q_e)
            seg_rho.append(rho_e)
            seg_w.append(w_e)
        n_grad = n_grad + nev
        seg_q = torch.stack(seg_q)        # [n_steps, C, D] travel order
        seg_rho = torch.stack(seg_rho)
        seg_w = torch.stack(seg_w)        # [n_steps, C]
        # backward segments into time order, time-oriented momenta
        t_ord = W(backward[None, :, None], torch.flip(seg_q, (0,)), seg_q)
        t_rho = W(backward[None, :, None], -torch.flip(seg_rho, (0,)),
                  seg_rho)

        # iterative sub-U-turn scan over the segment (walnuts.py:62-70)
        sub_ut = torch.zeros((C,), dtype=torch.bool, device=dev)
        span = n_steps
        while span >= 2:
            for i in range(n_steps // span):
                a_idx, b_idx = span * i, span * (i + 1) - 1
                sub_ut = sub_ut | uturn(t_ord[a_idx], t_rho[a_idx],
                                        t_ord[b_idx], t_rho[b_idx], inv_mass)
            span //= 2

        su = active & sub_ut
        done = done | su
        depth_stop = W(su, depth, depth_stop)
        ok = active & ~sub_ut

        # biased subtree accept + softmax selection within the subtree
        lse_ext = _logsumexp(seg_w, 0)
        u_acc = threefry.uniform(k_acc, (C,), dtype)
        accept = ok & (torch.log(torch.clamp(u_acc, min=1e-300))
                       < lse_ext - log_w_old)
        gumbel = threefry.gumbel(k_pick, seg_w.shape, dtype)
        pick = torch.argmax(seg_w + gumbel, dim=0)          # [C]
        q_sel = W(accept[:, None], seg_q[pick, rows], q_sel)

        # the new extreme state is the travel-order end
        fw = ok & ~backward
        bw = ok & backward
        qp, rhop = W(fw[:, None], q_e, qp), W(fw[:, None], rho_e, rhop)
        gp, lpp = W(fw[:, None], g_e, gp), W(fw, lp_e, lpp)
        w_end_f = W(fw, w_e, w_end_f)
        qm, rhom = W(bw[:, None], q_e, qm), W(bw[:, None], -rho_e, rhom)
        gm, lpm = W(bw[:, None], g_e, gm), W(bw, lp_e, lpm)
        w_end_b = W(bw, w_e, w_end_b)

        # joined-orbit U-turn with time-oriented momenta
        joined = uturn(qm, rhom, qp, rhop, inv_mass)
        stop_j = ok & joined
        done = done | stop_j
        depth_stop = W(stop_j, depth + 1, depth_stop)
        log_w_old = W(ok & ~joined, logaddexp(log_w_old, lse_ext), log_w_old)

    return PseudoResult(q=q_sel, n_grad=n_grad, depth_stopped=depth_stop)


def walnuts_pseudo(key, theta_init, *, target, inv_mass, macro_step,
                   max_depth: int = 10, max_error=0.1, iter_warmup: int = 0,
                   iter_sample: int = 1000, max_n: int = 10,
                   micro_policy: str = "uniform_3", device=DEFAULT_DEVICE):
    """Chain driver (``walnuts()``, ``walnuts.py:362-408``): no
    adaptation; transition ``i`` draws from ``fold_in(key, i)``.
    ``key`` is a threefry key or an int seed (``PRNGKey(seed)``);
    ``theta_init [C, D]`` (a tensor or a numpy array) is moved to
    ``device``, the card unless the caller passes ``device="cpu"``.
    Returns ``draws [iter_sample, C, D]``."""
    dev = resolve_device(device)
    if isinstance(key, int):
        key = threefry.PRNGKey(key, dev)
    key = key.to(dev)
    q = torch.as_tensor(theta_init).to(dev)
    draws = []
    for i in range(iter_warmup + iter_sample):
        q = walnuts_step_pseudo(
            threefry.fold_in(key, i), q, target=target, inv_mass=inv_mass,
            macro_step=macro_step, max_depth=max_depth, max_error=max_error,
            max_n=max_n, micro_policy=micro_policy).q
        if i >= iter_warmup:
            draws.append(q)
    return torch.stack(draws)
