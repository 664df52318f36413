"""Jobs that the port's multi-rank tests run on each rank (through
``walnuts_tpu_torch.parallel.run_ranks``).  This module imports torch
and the port only, so no rank imports JAX; each job returns numpy
arrays or Python values for the test process to check."""

import numpy as np
import torch
import torch.distributed as dist

import walnuts_tpu_torch as tw
from walnuts_tpu_torch import parallel
from walnuts_tpu_torch.diagnostics import ess, gather_chains, rhat, split_rhat


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
