"""The port's counterparts of ``__graft_entry__.py``'s entry points.

``entry()``              one scan-engine WALNUTS transition over a
                         funnel(101) chain batch, as ``(fn, args)``.
``dryrun_multichip(n)``  ``n`` ranks on this host, each
                         running one chain-split sampling step and one
                         round-capped fused invocation on its block of
                         a batch split over a 1-D mesh; the shapes are
                         checked on the gathered results.  With four
                         ranks or more, one scan-engine step on a 2-D
                         ``(chains, dim)`` mesh, held to the one-process
                         step.
"""

import torch

from .utils.device import DEFAULT_DEVICE, resolve_device


def _mk(dim=101, chains=32, m=6, dtype=torch.float32, device="cpu"):
    from . import targets
    from .sampler import WalnutsConfig, WarmupConfig

    target = targets.funnel(dim)
    cfg = WalnutsConfig(m=m)
    warmup = WarmupConfig(warmup_iter=100)
    q0 = torch.zeros((chains, dim), dtype=dtype, device=device)
    q0[:, 0] += 0.5
    return target, cfg, warmup, q0


def entry(device=DEFAULT_DEVICE):
    """Return ``(fn, example_args)``: ``fn(key, state)`` runs one WALNUTS
    transition of the scan engine on the flagship funnel(101) model (32
    chains, m=6, float32) and returns the new positions and the
    ``[32, 24]`` diagnostics.  The arguments lie on ``device``, the card
    unless the caller passes ``device="cpu"``."""
    from .sampler.driver import init_state, sampler_step
    from .utils import threefry

    dev = resolve_device(device)
    target, cfg, warmup, q0 = _mk(device=dev)
    state = init_state(target, q0, h0=0.3, delta0=0.3, warmup=warmup)

    def fn(key, state):
        new_state, res = sampler_step(key, state, target=target, cfg=cfg,
                                      warmup=warmup)
        return new_state.q, res.diagnostics

    return fn, (threefry.PRNGKey(0, dev), state)


def dryrun_multichip(n_devices: int, timeout: float = 300.0,
                     device=DEFAULT_DEVICE):
    """Start ``n_devices`` ranks on this host; each runs one chain-split
    ``sampler_step`` (funnel(7), ``2 n`` chains, m=3) and one
    round-capped fused invocation (``rounds=256``, ``diag_rows=4``,
    ``micro_unroll=2``) on its block, checks the gathered shapes and
    returns a short report (rank 0's).  ``device`` places the ranks
    (``parallel.rank_layout``): on the card unless the caller passes
    ``device="cpu"``, one card per rank (NCCL) where the host has
    enough, else all on one card (gloo).

    The 2-D ``(chains, dim)`` case (``n >= 4`` and even) runs one
    ``sampler_step`` (funnel(8), 4 chains, m=3, float64) on a
    ``make_mesh2(n/2, 2)`` block, joins its diagnostics and positions
    over both axes and holds them to the same step in one process under
    ``EXACT`` (the sums over D are taken in another order); the report
    carries both diagnostics."""
    from .parallel import run_ranks

    if resolve_device(device).type == "cuda":
        from . import _build

        _build.load()   # built once here, so that the ranks do not race
    return run_ranks(_dryrun_rank, n_devices, (str(device),),
                     timeout=timeout, device=device)[0]


def _dryrun_rank(device):
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from . import parallel
    from .diagnostics import gather_blocks, gather_chains
    from .sampler.driver import init_state, sampler_step
    from .sampler.megakernel import run_walnuts_fused
    from .sampler.transition import WalnutsConfig
    from .utils import threefry
    from .utils.parity import EXACT, assert_parity

    n = dist.get_world_size()
    dev, _ = parallel.rank_layout(device, n, dist.get_rank())
    target, cfg, warmup, q0 = _mk(dim=7, chains=2 * n, m=3, device=dev)
    mesh = parallel.make_mesh(n)
    state = parallel.shard_sampler_state(
        init_state(target, q0, h0=0.3, delta0=0.3, warmup=warmup), mesh)
    new_state, res = sampler_step(threefry.PRNGKey(0, dev), state,
                                  target=target, cfg=cfg, warmup=warmup,
                                  mesh=mesh)
    diag = parallel.gather_rows(res.diagnostics, mesh)
    assert tuple(diag.shape) == (2 * n, 24), diag.shape

    # the fused engine, chains split: every round is per-chain, so the
    # only collectives are the stop test's; one round-capped invocation
    Cf = 2 * n
    qf = 0.1 * threefry.normal(threefry.PRNGKey(2), (Cf, 7))
    hf = torch.full((Cf,), 0.4, dtype=qf.dtype)
    df = torch.full((Cf,), 0.3, dtype=qf.dtype)
    samples, diags, qc, cnt, ng, st = run_walnuts_fused(
        3, *parallel.shard_chains((qf, hf, df), mesh), target=target,
        cfg=WalnutsConfig(m=3), num_iter=4, rounds=256, diag_rows=4,
        micro_unroll=2, device=dev, mesh=mesh)
    cnt = parallel.gather_rows(cnt, mesh)
    assert tuple(cnt.shape) == (Cf,), cnt.shape
    draws = gather_chains(samples, mesh)
    assert tuple(draws.shape) == (4, Cf, 7), draws.shape
    report = dict(ranks=n, diag=tuple(diag.shape), counts=tuple(cnt.shape),
                  draws=tuple(draws.shape),
                  grads=parallel.reduce_int(ng, mesh, "sum"))

    # tensor-parallel case: [C, D] over a 2-D (chains, dim) mesh; every
    # sum over D is all-reduced over the rank's dim group
    if n >= 4 and n % 2 == 0:
        target2, cfg2, warmup2, q2 = _mk(dim=8, chains=4, m=3,
                                         dtype=torch.float64, device=dev)
        key = threefry.PRNGKey(1, dev)
        _, one = sampler_step(key, init_state(target2, q2, h0=0.3,
                                              delta0=0.3, warmup=warmup2),
                              target=target2, cfg=cfg2, warmup=warmup2)
        mesh2 = parallel.make_mesh2(n // 2, 2)
        block = parallel.shard_chains_dim(q2, mesh2)
        state2 = init_state(target2, block, h0=0.3, delta0=0.3,
                            warmup=warmup2, mesh=mesh2)
        new2, res2 = sampler_step(key, state2, target=target2, cfg=cfg2,
                                  warmup=warmup2, mesh=mesh2)
        diag2 = gather_blocks(res2.diagnostics, mesh2, 0, cols=False).cpu()
        q_new = gather_blocks(new2.q, mesh2, 0).cpu()
        assert tuple(diag2.shape) == (4, 24), diag2.shape
        assert_parity(one.diagnostics.cpu().numpy(), diag2.numpy(), EXACT,
                      "dim-split diagnostics")
        assert_parity(one.q.cpu().numpy(), q_new.numpy(), EXACT,
                      "dim-split positions")
        report["dim_split"] = dict(block=tuple(block.shape),
                                   diag=diag2.numpy(),
                                   one_process=one.diagnostics.cpu().numpy())
    report["rank"] = dist.get_rank()
    return report


__all__ = ["entry", "dryrun_multichip"]
