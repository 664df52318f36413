"""Chains and columns split over ``torch.distributed`` ranks
(``walnuts_tpu/parallel``).

Chains are the data-parallel axis.  Each rank runs an engine on its own
block of the ``[C, D]`` batch (:func:`shard_chains`), passing the mesh
(:func:`make_mesh`) as ``mesh=``; every per-chain computation stays
local, and collectives appear only in

* the pooled warmup consensus (the batch median over all ranks),
* the fused engine's stop test, and
* cross-chain diagnostics on gathered draws
  (:func:`..diagnostics.gather_chains`).

A rank's draws and results equal its rows of a single-process run.
The scan engine also takes a 2-D ``(chains, dim)`` mesh
(:func:`make_mesh2`, :func:`shard_chains_dim`): a rank holds a block of
chains and a window of columns (:func:`dim_block`), and every sum over
D is all-reduced over the rank's dim group (:func:`dim_split` and its
collectives); :func:`..diagnostics.gather_blocks` joins both axes.
:func:`run_ranks` starts such a group of processes on one host, placed
by :func:`rank_layout` (gloo for ranks on the CPU or sharing one card,
NCCL for a card per rank).
"""

from .mesh import (
    chain_block,
    current_dim_split,
    dim_all,
    dim_any,
    dim_block,
    dim_gather,
    dim_max,
    dim_split,
    dim_sum,
    distributed_init,
    gather_cols,
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
    "gather_cols",
    "dim_block",
    "dim_split",
    "current_dim_split",
    "dim_sum",
    "dim_max",
    "dim_any",
    "dim_all",
    "dim_gather",
    "reduce_int",
    "run_ranks",
]
