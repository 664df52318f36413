"""Jobs that the port's multi-rank tests run on each rank (through
``walnuts_tpu_torch.parallel.run_ranks``).  This module imports torch
and the port only, so no rank imports JAX; each job returns numpy
arrays or Python values for the test process to check."""

import numpy as np
import torch
import torch.distributed as dist

import walnuts_tpu_torch as tw
from walnuts_tpu_torch import parallel
from walnuts_tpu_torch.diagnostics import (ess, gather_blocks, gather_chains,
                                          rhat, split_rhat)


def _np(x):
    return x.cpu().numpy()


def scan_and_fused(q_scan, q_fused, draws, seed):
    """The chain-split engines on this rank's block, gathered:
    ``run_walnuts`` per chain and pooled (std_gauss(6), m=4, 5 warmup,
    10 iterations), the fused plain run (funnel(7), m=4, 160 rounds,
    pooled warmup), and ESS / Rhat of gathered ``[N, C, K]`` draws; plus
    the mesh and placement errors on two ranks."""
    mesh = parallel.make_mesh()
    out = {"world": mesh.size()}
    q = parallel.shard_chains(q_scan, mesh)
    for pooled in (False, True):
        s, d, st = tw.run_walnuts(
            1, q, target=tw.targets.std_gauss(6), cfg=tw.WalnutsConfig(m=4),
            warmup=tw.WarmupConfig(warmup_iter=5, pooled=pooled),
            num_iter=10, h0=0.5, delta0=0.1, device="cpu", mesh=mesh)
        out[f"scan_{pooled}"] = [_np(gather_chains(x, mesh))
                                 for x in (s, d)] + [
            _np(parallel.gather_rows(x, mesh)) for x in (st.h, st.delta)]

    C = q_fused.shape[0]
    qf, h, dl = parallel.shard_chains(
        (q_fused, np.full(C, 0.4), np.full(C, 0.15)), mesh)
    res = tw.sampler.run_walnuts_fused_plain(
        seed, qf, h, dl, target=tw.targets.funnel(7),
        cfg=tw.WalnutsConfig(m=4), num_iter=20, stop_mode="per_chain",
        warmup=tw.WarmupConfig(warmup_iter=20, pooled=True), rounds=160,
        micro_unroll=2, device="cpu", mesh=mesh)
    samples, diags, qc, cnt, ng, h_out, d_out = res[:7]
    out["fused"] = [_np(gather_chains(samples, mesh)),
                    _np(gather_chains(diags, mesh))] + [
        _np(parallel.gather_rows(x, mesh)) for x in (qc, cnt, h_out, d_out)]
    out["fused_grads"] = parallel.reduce_int(ng, mesh, "sum")
    out["fused_rounds"] = res[-1].n

    r, n = mesh.get_local_rank(), mesh.size()
    block = torch.from_numpy(draws)[:, r * draws.shape[1] // n:
                                    (r + 1) * draws.shape[1] // n]
    full = gather_chains(block, mesh)
    out["diag_stats"] = [_np(f(full)) for f in (ess, rhat, split_rhat)]

    errors = {}
    for name, call in (
            ("uneven", lambda: parallel.shard_chains(torch.zeros(5, 3),
                                                     mesh)),
            ("mesh", lambda: parallel.make_mesh(n + 1)),
            ("mesh2", lambda: parallel.make_mesh2(n, 2))):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    mesh2 = parallel.make_mesh2(n, 1)
    out["dim_block"] = tuple(parallel.shard_chains_dim(
        torch.zeros(8, 6), mesh2).shape)
    try:
        tw.run_walnuts_fused(1, torch.zeros(4, 6), 0.3, 0.3,
                             target=tw.targets.std_gauss(6),
                             cfg=tw.WalnutsConfig(m=3), num_iter=2,
                             device="cpu", mesh=mesh2)
    except NotImplementedError as e:
        errors["dim_split"] = str(e)
    out["errors"] = errors
    return out


def distributed_smoke(C, D):
    """``tests/test_distributed.py``'s worker: a chain-split
    ``run_walnuts`` step over two processes and a cross-rank sum."""
    pid, n = dist.get_rank(), dist.get_world_size()
    mesh = parallel.make_mesh(n)
    local = 0.1 * np.arange(C // n * D, dtype=np.float32).reshape(
        C // n, D) + pid
    s, d, st = tw.run_walnuts(
        0, local, target=tw.targets.std_gauss(D), cfg=tw.WalnutsConfig(m=3),
        warmup=tw.WarmupConfig(warmup_iter=0, adapt_h=False,
                               adapt_delta=False),
        num_iter=3, h0=0.5, delta0=0.2, device="cpu", mesh=mesh)
    tot = torch.tensor([float(np.sum(local))], dtype=torch.float64)
    dist.all_reduce(tot, group=mesh.get_group())
    return dict(pid=pid, local_shape=tuple(s.shape),
                samples=_np(gather_chains(s, mesh)), total=float(tot),
                local_sum=float(np.sum(local)))


def fail_on_rank_one():
    """Raises on rank 1 only; rank 0 waits at a barrier it never
    leaves, so the launcher must take the group down."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank one failed on purpose")
    dist.barrier()


# ---------------------------------------------------------------------------
# the dim split: a 2 x 2 (chains, dim) mesh (tests/test_torch_dim_split.py)
# ---------------------------------------------------------------------------

def radius(q):
    """A target's own generated quantities: ``(q_0, sum q^2)``."""
    return torch.stack([q[..., 0], torch.sum(q * q, dim=-1)], dim=-1)


def _dim_target(spec):
    name, *args = spec
    if name == "std_gauss_radius":
        return tw.targets.std_gauss(*args, generated=radius)
    return getattr(tw.targets, name)(*args)


def _dim_scan(case, mesh):
    """One ``run_walnuts`` case on this rank's block of the 2-D mesh,
    joined over both axes, with this rank's own diagnostics block."""
    target = _dim_target(case["target"])
    inv_mass = case.get("inv_mass")
    orbit = case.get("orbit", False)
    cfg = tw.WalnutsConfig(
        m=case["m"], integrator=case["integrator"],
        use_inv_mass=inv_mass is not None, record_orbit_stats=orbit,
        igr=tw.ops.IntegratorConfig(fp_newton=case.get("newton", False)))
    out = tw.run_walnuts(
        case["seed"], parallel.shard_chains_dim(case["q0"], mesh),
        target=target, cfg=cfg,
        warmup=tw.WarmupConfig(warmup_iter=case["warmup_iter"],
                               pooled=case["pooled"]),
        num_iter=case["num_iter"], h0=case["h0"], delta0=case["delta0"],
        inv_mass=inv_mass, collect_orbit_stats=orbit, device="cpu",
        mesh=mesh)
    s, d, st = out[:3]
    cols = target._generated is None     # generated quantities by column

    def rows(x, chain_dim=0):
        return _np(gather_blocks(x, mesh, chain_dim, cols=False))

    state = {f: rows(getattr(st, f)) for f in ("lp", "h", "delta",
                                                 "err_facs")}
    state.update({f: _np(gather_blocks(getattr(st, f), mesh, 0))
                  for f in ("q", "g")})
    state["p2"] = {f: rows(getattr(st.p2, f)) for f in st.p2._fields}
    state["iter_n"] = st.iter_n
    res = dict(samples=_np(gather_blocks(s, mesh, 1, cols=cols)),
               diag=rows(d, 1), diag_local=_np(d), state=state,
               width=st.q.shape[-1])
    if orbit:
        res["orbit"] = [_np(gather_blocks(x, mesh, 1, cols=cols))
                        for x in out[3:]]
    return res


def _part_b(case, mesh):
    """One run of the streaming engine, generic NUTS or the multinomial
    sampler on this rank's block of ``mesh`` (its chains of a 1-D mesh,
    its chains and columns of a 2-D one), joined over both axes:
    ``(outputs, this rank's own diagnostics)``."""
    kind = case["kind"]
    sp = tw.sampler
    target = _dim_target(case["target"])
    kernel = sp.HMCKernel() if case.get("kernel") == "hmc" \
        else sp.IsokineticKernel()

    def cols(x, chain_dim=1):
        return _np(gather_blocks(x, mesh, chain_dim))

    def rows(x, chain_dim=1):
        return _np(gather_blocks(x, mesh, chain_dim, cols=False))

    if kind == "streaming":
        q, h, dl = parallel.shard_chains_dim(
            (case["q0"], case["h"], case["delta"]), mesh)
        s, d, qf = sp.run_walnuts_streaming(
            case["seed"], q, h, dl, target=target,
            cfg=tw.WalnutsConfig(m=case["m"]), num_iter=case["num_iter"],
            rng=case["rng"], device="cpu", mesh=mesh)
        return [cols(s), rows(d), cols(qf, 0)], _np(d)
    q = parallel.shard_chains_dim(case["q0"], mesh)
    if kind == "generic":
        s, d = sp.run_generic_nuts(
            case["seed"], q, target=target, kernel=kernel,
            h_macro=case["h"], delta=case["delta"],
            num_iter=case["num_iter"], m=case["m"], device="cpu", mesh=mesh)
        return [cols(s), rows(d)], _np(d)
    s, d, (h, dl) = sp.run_multinomial(
        case["seed"], q, target=target, kernel=kernel,
        cfg=sp.MultinomialConfig(l_orbit=case["l_orbit"],
                                 wasps=case.get("wasps", True)),
        h0=case["h"], delta0=case["delta"], num_iter=case["num_iter"],
        warmup_iter=case["warmup_iter"], scale=case.get("scale", 1.0),
        center=case.get("center", 0.0), device="cpu", mesh=mesh)
    return [cols(s), rows(d), rows(h, 0), rows(dl, 0)], _np(d)


def dim_split(scan_cases, part_b_cases, dim_b_cases):
    """Every case of the dim-split tests on a 2 x 2 mesh: the scan
    engine's cases and the other engines' dim cases on the rank's (chain
    rows, column block), the Part B cases on the rank's chains of the
    mesh's chains axis (two ranks; each column of the mesh runs them
    alike), and which engines raise on the 2-D mesh."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh2(2, 2)
    out = {"block": parallel.dim_block(mesh, 11),
           "scan": {k: _dim_scan(c, mesh) for k, c in scan_cases.items()},
           "part_b": {k: _part_b(c, mesh["chains"])[0]
                      for k, c in part_b_cases.items()},
           "dim_b": {k: _part_b(c, mesh) for k, c in dim_b_cases.items()}}
    errors = {}
    q, h = parallel.shard_chains_dim((np.zeros((8, 5)), np.full(8, 0.3)),
                                     mesh)
    for name, call in (
            ("streaming", lambda: tw.sampler.run_walnuts_streaming(
                1, q, h, h,
                target=tw.targets.std_gauss(5), cfg=tw.WalnutsConfig(m=3),
                num_iter=1, device="cpu", mesh=mesh)),
            ("generic", lambda: tw.sampler.run_generic_nuts(
                1, q, target=tw.targets.std_gauss(5),
                kernel=tw.sampler.IsokineticKernel(), h_macro=0.3,
                delta=0.3, num_iter=1, device="cpu", mesh=mesh)),
            ("multinomial", lambda: tw.sampler.run_multinomial(
                1, q, target=tw.targets.std_gauss(5), num_iter=1,
                device="cpu", mesh=mesh)),
            ("fused", lambda: tw.run_walnuts_fused(
                1, q, 0.3, 0.3, target=tw.targets.std_gauss(5),
                cfg=tw.WalnutsConfig(m=3), num_iter=1, device="cpu",
                mesh=mesh))):
        try:
            call()
        except NotImplementedError as e:
            errors[name] = str(e)
    out["errors"] = errors
    out["rank"], out["coords"] = dist.get_rank(), tuple(
        mesh.get_coordinate())
    return out


# ---------------------------------------------------------------------------
# the fused engine's launch-ahead (tests/test_torch_launch_ahead.py)
# ---------------------------------------------------------------------------

class Counted:
    """``round_kernel.run_rounds`` wrapped, while the context is open, to
    count the flush periods it runs (``periods``)."""

    def __enter__(self):
        from walnuts_tpu_torch.sampler import round_kernel as rk

        self.rk, self.real, self.periods = rk, rk.run_rounds, 0

        def run_rounds(*args):
            self.periods += 1
            self.real(*args)

        rk.run_rounds = run_rounds
        return self

    def __exit__(self, *exc):
        self.rk.run_rounds = self.real
        return False


def period_by_period(call):
    """``call(rounds, mk_state)`` as calls of one flush period, each
    resumed from the last one's state, until a call launches nothing.
    Returns ``(the last call's outputs, [C] draw counts before the first
    period and after each, the stop test's reads of each call)``."""
    from walnuts_tpu_torch.sampler import megakernel as mk

    out, its, reads, st = None, [], [], None
    while True:
        mk.stop_readbacks = 0
        with Counted() as c:
            out = call(mk.FLUSH_EVERY, st)
        reads.append(mk.stop_readbacks)
        if not its:
            its.append(torch.zeros_like(out[-1].it))
        if not c.periods:
            return out, its, reads
        st = out[-1]
        its.append(st.it.clone())


def launch_ahead(q0, seed, cases):
    """``tests/test_torch_launch_ahead.py``'s two ranks: for each
    ``(stop_mode, num_iter)`` of ``cases``, funnel(7) on this rank's
    block run to its stop in one call and period by period.  Returns per
    case the call's rounds, periods and stop-test reads, whether its
    state equals the period-by-period run's bit for bit, and every
    chain's draw count before each period, gathered."""
    from walnuts_tpu_torch.sampler import megakernel as mk

    mesh = parallel.make_mesh()
    C = q0.shape[0]
    q, h, dl = parallel.shard_chains(
        (q0, np.full(C, 0.4), np.full(C, 0.15)), mesh)
    out = []
    for mode, num_iter in cases:
        def call(rounds, st):
            return tw.run_walnuts_fused(
                seed, q, h, dl, target=tw.targets.funnel(7),
                cfg=tw.WalnutsConfig(m=4), num_iter=num_iter,
                stop_mode=mode, rounds=rounds, mk_state=st, device="cpu",
                mesh=mesh)

        ref, its, _ = period_by_period(call)
        mk.stop_readbacks = 0
        with Counted() as c:
            one = call(10 ** 6, None)
        same = all(torch.equal(a, b)
                   for a, b in zip(flat(one[-1]), flat(ref[-1])))
        out.append(dict(
            rounds=one[-1].n, periods=c.periods, reads=mk.stop_readbacks,
            same=same, its=[_np(parallel.gather_rows(x, mesh))
                            for x in its]))
    return out


def flat(x):
    """Every tensor of a (nested) tuple of a run's state, in order; a
    number as a 0-dim tensor."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in flat(v)]
    return [torch.as_tensor(x)]
