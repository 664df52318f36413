"""Generic-step NUTS: orbit doubling over pluggable dynamics kernels
(``walnuts_tpu/sampler/generic_nuts.py``).

The reference's research sampler ``NUTSampler``
(``isokinetic/WALNUTS.py:113-403``) runs one NUTS orbit machinery over
Hamiltonian or isokinetic step objects (:mod:`.kernels`):

* per-state log weight ``-Ham_i + cljac_dir``, where ``cljac`` sums the
  step kernel's returned log-weights along each direction;
* online multinomial selection within each suborbit, then a biased
  progressive accept of the suborbit's candidate with probability
  ``subOrbitWtSum / accWtsum``;
* sub-U-turn checks on the new suborbit interleaved with integration:
  a hit rejects the suborbit and stops (``NUTtype 1``); a joined-orbit
  U-turn stops after the accept (``NUTtype 0``); exhausting ``M``
  doublings gives ``NUTtype 2``;
* the first leg is a single step in a random direction with an
  immediate accept test.

As in :mod:`.transition`, the doubling loop is the flat static schedule
``build_schedule(M + 1)``, walked by a host loop that ends once every
chain has stopped (one host sync per step); the schedule's tables are
host values.  Weights are kept in log space with JAX's ``logaddexp``.

Randomness is JAX's threefry stream: ``split(key, 3)`` into momentum,
directions and orbit keys; per schedule step ``t``, ``split(fold_in(
k_orbit, t), 5)`` gives the (unused) step keys, the two selection
uniforms and the acceptance uniform.  All steps' uniforms are drawn in
one batched pass before the loop, with the per-step draws' bits.  With
the chains split over the ranks of a mesh every draw is the rank's rows
of the whole batch's (``chain_block``), and nothing is pooled across
chains, so the chain ranks need no collective.  On a ``(chains, dim)``
mesh the transition runs inside :func:`..parallel.mesh.dim_split`: the
momentum is the rank's columns of the whole draw, and every energy,
U-turn dot and step-kernel norm is its dim group's sum, so each flag
the host loop reads is the same on every rank of the group.

Diagnostics columns (one row per chain per iteration): ``DIAG_COLS``.
"""

import torch

from ..ops.hamiltonian import uturn
from ..ops.isokinetic import MCState, draw_window, where_state
from ..parallel.mesh import chain_block, chain_ranks, dim_split
from ..utils import threefry
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .plans import build_schedule

DIAG_COLS = ["NutsIter", "L", "a", "b", "aInt", "bInt", "NUTtype",
             "gradEvals", "energyErr", "minIf", "maxIf", "propBasic"]


def logaddexp(x1, x2):
    """``jnp.logaddexp``: ``max + log1p(exp(-|x1 - x2|))``, and ``x1 +
    x2`` where the difference is NaN (infinities of one sign)."""
    amax = torch.maximum(x1, x2)
    delta = x1 - x2
    return torch.where(torch.isnan(delta), x1 + x2,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


def generic_nuts_transition(key, state: MCState, h_macro, delta, *,
                            target, kernel, m: int, chain_block=None):
    """One NUTS transition over a generic step kernel for a ``[C, D]``
    batch, on the device of ``state``.  ``key`` is a threefry key
    (``[2]`` int64 words); ``h_macro`` and ``delta`` are ``[C]``; ``m``
    is the number of doublings after the initial single step (the
    reference's ``M``).  ``chain_block = (c0, C_total)`` when the batch
    is chains ``c0 .. c0+C-1`` of ``C_total``: the draws are those rows
    of the whole batch's.  Returns ``(new_state, diagnostics [C, 12])``;
    the new state's velocity is zero, as in JAX."""
    C, D = state.q.shape
    dtype, dev = state.q.dtype, state.q.device
    sched = build_schedule(m + 1)
    T, S = sched.n_steps, sched.capacity

    (Cg,), rows, _ = draw_window((C,), chain_block)
    k_mom, k_dirs, k_orbit = threefry.split(key, 3)
    state = kernel.refresh(k_mom, state, chain_block)
    lwt0 = -kernel.ham(state)
    xi_all = threefry.bernoulli(k_dirs, 0.5, (Cg, m + 1), rows=rows)
    sub = threefry.split(threefry.fold_in(
        k_orbit, torch.arange(T, dtype=torch.int64, device=dev)), 5)
    u_s = [threefry.uniform(sub[:, j], (Cg,), dtype, rows=rows)
           for j in (2, 3)]
    u_acc = threefry.uniform(sub[:, 4], (Cg,), dtype, rows=rows)

    zf = torch.zeros((C,), dtype=dtype, device=dev)
    zi = torch.zeros((C,), dtype=torch.int32, device=dev)
    zb = torch.zeros((C,), dtype=torch.bool, device=dev)
    neg_inf = torch.full((C,), -torch.inf, dtype=dtype, device=dev)
    big_i = torch.full((C,), 2 ** 30, dtype=torch.int32, device=dev)
    c = dict(
        sp=state, sm=state, cljac_p=zf, cljac_m=zf,
        q_sel=state.q, lp_sel=state.lp, g_sel=state.g, l_sel=zi,
        q_sub=state.q, lp_sub=state.lp, g_sub=state.g, l_sub=zi,
        log_acc=zf, log_sub=neg_inf,
        a=zi, b=zi, a_new=zi, b_new=zi,
        done=zb, depth_done=zb, nuts_type=torch.full_like(zi, 2),
        nuts_iter=zi,
        slab_q=torch.zeros((C, S, D), dtype=dtype, device=dev),
        slab_v=torch.zeros((C, S, D), dtype=dtype, device=dev),
        n_evals=zi, e_err_max=zf, if_min=big_i, if_max=-big_i,
        n_basic=zi, n_steps=zi,
    )
    W = torch.where

    def one_step(u, fwd, slot, active, is_d0):
        """Integrate one macro step from the active end of each chain,
        update weights and selection, checkpoint into the slab."""
        f1 = fwd[:, None]
        end = where_state(fwd, c["sp"], c["sm"])
        # backward integration flips, steps, flips back
        end_in = end._replace(u=W(f1, end.u, -end.u))
        new, lwt_step, stats = kernel.step(None, target, end_in, h_macro,
                                           delta, active)
        new = new._replace(u=W(f1, new.u, -new.u))

        af, ab = active & fwd, active & ~fwd
        c["sp"] = where_state(af, new, c["sp"])
        c["sm"] = where_state(ab, new, c["sm"])
        c["cljac_p"] = c["cljac_p"] + W(af, lwt_step, 0.0)
        c["cljac_m"] = c["cljac_m"] + W(ab, lwt_step, 0.0)

        cljac = W(fwd, c["cljac_p"], c["cljac_m"])
        ham = kernel.ham(new)
        wt_log = W(torch.isfinite(ham), -ham + cljac - lwt0, -torch.inf)

        c["log_sub"] = W(active, logaddexp(c["log_sub"], wt_log),
                         c["log_sub"])
        abs_id = W(fwd, c["b_new"] + 1, c["a_new"] - 1)

        # depth 0: accept directly into the sampled state against
        # accWtsum; deeper: within-suborbit online multinomial
        p_log = wt_log - (c["log_acc"] if is_d0 else c["log_sub"])
        sel = active & (torch.log(torch.clamp(u, min=1e-300)) < p_log)
        s1 = sel[:, None]
        pre = "sel" if is_d0 else "sub"
        c["a_new"] = W(ab, c["a_new"] - 1, c["a_new"])
        c["b_new"] = W(af, c["b_new"] + 1, c["b_new"])
        c["q_" + pre] = W(s1, new.q, c["q_" + pre])
        c["lp_" + pre] = W(sel, new.lp, c["lp_" + pre])
        c["g_" + pre] = W(s1, new.g, c["g_" + pre])
        c["l_" + pre] = W(sel, abs_id, c["l_" + pre])
        a1 = active[:, None]
        c["slab_q"][:, slot] = W(a1, new.q, c["slab_q"][:, slot])
        c["slab_v"][:, slot] = W(a1, kernel.velocity(new),
                                 c["slab_v"][:, slot])
        c["n_evals"] = c["n_evals"] + stats.n_evals
        c["e_err_max"] = W(active, torch.maximum(
            c["e_err_max"], torch.abs(stats.energy_err)), c["e_err_max"])
        c["if_min"] = W(active, torch.minimum(c["if_min"], stats.i_f),
                        c["if_min"])
        c["if_max"] = W(active, torch.maximum(c["if_max"], stats.i_f),
                        c["if_max"])
        c["n_basic"] = c["n_basic"] + (active & stats.basic).to(torch.int32)
        c["n_steps"] = c["n_steps"] + active.to(torch.int32)
        return new

    t = 0
    while t < T and bool((~c["done"]).any()):
        depth_t = int(sched.depth[t])
        is_d0 = bool(sched.is_depth0[t])
        last = bool(sched.last_of_depth[t])
        first = t == 0 or depth_t != int(sched.depth[t - 1])
        fwd = xi_all[:, depth_t]
        f1 = fwd[:, None]

        # a new suborbit begins: fold the previous suborbit's weight
        # into the accepted-orbit sum
        if first and not is_d0:
            snap = ~c["done"]
            c["log_acc"] = W(snap, logaddexp(c["log_acc"], c["log_sub"]),
                             c["log_acc"])
            c["log_sub"] = W(snap, -torch.inf, c["log_sub"])

        alive = ~c["done"] & ~c["depth_done"]
        s1 = one_step(u_s[0][t], fwd, int(sched.slot1[t]), alive, is_d0)
        if not is_d0:
            # at depth 0 no chain is active in the second step, so it
            # and the checks change nothing
            act2 = alive
            s2 = one_step(u_s[1][t], fwd, int(sched.slot2[t]), act2, False)

            # adjacent U-turn between the two new states (the earlier
            # state first in orbit time)
            v1, v2 = kernel.velocity(s1), kernel.velocity(s2)
            depth_done = c["depth_done"] | (act2 & uturn(
                W(f1, s1.q, s2.q), W(f1, v1, v2), W(f1, s2.q, s1.q),
                W(f1, v2, v1)))

            # merge checks from the slab
            for kk in range(sched.max_post):
                if not sched.post_valid[t, kk]:
                    continue
                slo = int(sched.post_slot_lo[t, kk])
                shi = int(sched.post_slot_hi[t, kk])
                q_lo, v_lo = c["slab_q"][:, slo], c["slab_v"][:, slo]
                q_hi, v_hi = c["slab_q"][:, shi], c["slab_v"][:, shi]
                depth_done = depth_done | (act2 & uturn(
                    W(f1, q_lo, q_hi), W(f1, v_lo, v_hi),
                    W(f1, q_hi, q_lo), W(f1, v_hi, v_lo)))

            # suborbit rejected by a sub-U-turn: stop, keep the sample
            newly_su = (depth_done & ~c["depth_done"]) & ~c["done"]
            c["depth_done"] = depth_done
            c["nuts_type"] = W(newly_su, 1, c["nuts_type"])
            c["nuts_iter"] = W(newly_su, depth_t, c["nuts_iter"])
            c["done"] = c["done"] | newly_su

        # depth end: biased progressive accept + global U-turn
        if last:
            p_mask = ~c["done"] & ~c["depth_done"]
            if is_d0:
                take = zb
            else:
                take = p_mask & (
                    torch.log(torch.clamp(u_acc[t], min=1e-300))
                    < c["log_sub"] - c["log_acc"])
            joined = uturn(c["sm"].q, kernel.velocity(c["sm"]),
                           c["sp"].q, kernel.velocity(c["sp"]))
            stop_g = p_mask & joined
            t1 = take[:, None]
            c["q_sel"] = W(t1, c["q_sub"], c["q_sel"])
            c["lp_sel"] = W(take, c["lp_sub"], c["lp_sel"])
            c["g_sel"] = W(t1, c["g_sub"], c["g_sel"])
            c["l_sel"] = W(take, c["l_sub"], c["l_sel"])
            c["nuts_type"] = W(stop_g, 0, c["nuts_type"])
            c["nuts_iter"] = W(p_mask, depth_t, c["nuts_iter"])
            c["done"] = c["done"] | stop_g
            c["a"] = W(p_mask, c["a_new"], c["a"])
            c["b"] = W(p_mask, c["b_new"], c["b"])
            c["depth_done"] = zb
        t += 1

    nst = torch.clamp(c["n_steps"], min=1).to(dtype)
    cols = [c["nuts_iter"], c["l_sel"], c["a"], c["b"], c["a_new"],
            c["b_new"], c["nuts_type"], c["n_evals"], c["e_err_max"],
            c["if_min"], c["if_max"], c["n_basic"].to(dtype) / nst]
    diag = torch.stack([x.to(dtype) for x in cols], dim=-1)
    new_state = MCState(c["q_sel"], torch.zeros_like(c["q_sel"]),
                        c["g_sel"], c["lp_sel"])
    return new_state, diag


def run_generic_nuts(seed, q0, *, target, kernel, h_macro, delta,
                     num_iter: int, m: int = 10, device=DEFAULT_DEVICE,
                     mesh=None):
    """Chain driver (``NUTSampler.run``): fixed tuning, full momentum
    refresh per iteration; ``wt.sampler.run_generic_nuts(
    jax.random.PRNGKey(seed), q0, ...)``.

    ``seed`` is an int (the key is ``PRNGKey(seed)``) or a threefry key.
    ``q0`` (a tensor or a numpy array) is moved to ``device``, the card
    unless the caller passes ``device="cpu"``; dtype comes from ``q0``.
    The iteration keys are ``fold_in(key, i)`` for ``i = 1 ..
    num_iter``.

    ``mesh``: a 1-D mesh (:func:`..parallel.make_mesh`): ``q0`` is this
    rank's block of chains (:func:`..parallel.shard_chains`) and the
    outputs are its rows of the single-process run's.  On a ``(chains,
    dim)`` mesh (:func:`..parallel.make_mesh2`) ``q0`` is this rank's
    (chain rows, column block) (:func:`..parallel.shard_chains_dim`) and
    the rank returns its block, as ``run_walnuts`` does: samples of an
    identity ``generated`` hold the rank's columns, those of a target's
    own ``generated`` and the diagnostics whole rows
    (:func:`..diagnostics.gather_blocks` joins both axes).

    Returns ``(samples [num_iter+1, C, dg], diagnostics [num_iter, C,
    12])``; row 0 of ``samples`` is the generated quantities of ``q0``.
    """
    dev = resolve_device(device)
    key = (seed.to(device=dev, dtype=torch.int64)
           if isinstance(seed, torch.Tensor) else threefry.PRNGKey(seed, dev))
    q0 = torch.as_tensor(q0).to(dev)
    C = q0.shape[0]
    block = chain_block(mesh, C) if chain_ranks(mesh) > 1 else None
    h = torch.full((C,), h_macro, dtype=q0.dtype, device=dev)
    d = torch.full((C,), delta, dtype=q0.dtype, device=dev)
    with dim_split(mesh, target.dim):
        state = kernel.init(target, q0)
        gen0 = target.generated(q0)
        samples = torch.empty((num_iter + 1,) + tuple(gen0.shape),
                              dtype=gen0.dtype, device=dev)
        samples[0] = gen0
        diags = torch.empty((num_iter, C, len(DIAG_COLS)), dtype=q0.dtype,
                            device=dev)
        for i in range(1, num_iter + 1):
            state, diags[i - 1] = generic_nuts_transition(
                threefry.fold_in(key, i), state, h, d, target=target,
                kernel=kernel, m=m, chain_block=block)
            samples[i] = target.generated(state.q)
    return samples, diags
