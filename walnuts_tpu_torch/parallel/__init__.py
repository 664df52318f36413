"""Chains split over ``torch.distributed`` ranks (``walnuts_tpu/parallel``).

Chains are the data-parallel axis.  Each rank runs an engine on its own
block of the ``[C, D]`` batch (:func:`shard_chains`), passing the mesh
(:func:`make_mesh`) as ``mesh=``; every per-chain computation stays
local, and collectives appear only in

* the pooled warmup consensus (the batch median over all ranks),
* the fused engine's stop test, and
* cross-chain diagnostics on gathered draws
  (:func:`..diagnostics.gather_chains`).

A rank's draws and results equal its rows of a single-process run.
:func:`run_ranks` starts such a group of processes on one host, placed
by :func:`rank_layout` (gloo for ranks on the CPU or sharing one card,
NCCL for a card per rank).
"""

from .mesh import (
    chain_block,
    distributed_init,
    gather_rows,
    make_mesh,
    make_mesh2,
    rank_layout,
    reduce_int,
    replicate,
    shard_chains,
    shard_chains_dim,
    shard_sampler_state,
)
from .spawn import run_ranks

__all__ = [
    "make_mesh",
    "make_mesh2",
    "shard_chains",
    "shard_chains_dim",
    "shard_sampler_state",
    "replicate",
    "distributed_init",
    "rank_layout",
    "chain_block",
    "gather_rows",
    "reduce_int",
    "run_ranks",
]
