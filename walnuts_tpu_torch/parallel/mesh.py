"""Chain placement over ``torch.distributed`` ranks
(``walnuts_tpu/parallel/mesh.py``).

JAX places a ``[C, D]`` batch on a ``('chains',)`` mesh and lets GSPMD
split every op.  Here each rank holds its own block of chains as plain
local tensors (no DTensor: the round kernel takes raw pointers through
ctypes), and an engine given the mesh does two things a single process
does not need:

* it keys its random draws by the global chain id (the threefry row
  window of the scan engine, the hash's chain offset ``c0`` in the
  fused engine), so rank r's chains draw what rows
  ``[r C/R, (r+1) C/R)`` draw in one process;
* it makes the few cross-chain steps collective: the pooled warmup
  median (an all-gather in rank order) and the fused engine's stop test
  (an all-reduce).

A mesh of one rank, or none, takes exactly the single-process path.
The backend follows where the ranks keep their tensors
(:func:`rank_layout`): ranks on the CPU, or ranks that share one card,
use gloo, which stages CUDA tensors through the host here; ranks with
a card each use NCCL.
"""

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.tree import tree_map

# The engine step over a dim-split (chains, dim) mesh waits for this item.
DIM_SPLIT_ITEM = "ROADMAP queue 1, the dim split of a (chains, dim) mesh"


def rank_layout(device, num_processes: int, process_id: int):
    """``(device, backend)`` of rank ``process_id`` of ``num_processes``
    ranks on one host, from where the caller puts them; every rank
    derives the same backend.

    * ``"cpu"``: the ranks' tensors on the CPU, gloo;
    * ``"cuda:k"``: every rank on card k, gloo (NCCL refuses two ranks on
      one card; gloo stages the collectives' CUDA tensors through the
      host);
    * ``"cuda"``: rank r on card r, NCCL, when the host has a card for
      every rank; otherwise every rank on the current card, gloo.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    if dev.type != "cuda":
        raise ValueError(f"ranks run on the CPU or the card, not {dev}")
    if dev.index is None and torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes:
        return torch.device("cuda", process_id), "nccl"
    return resolve_device(dev), "gloo"


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=DEFAULT_DEVICE) -> Optional[torch.device]:
    """Join ``num_processes`` processes into one process group and return
    this rank's device (a no-op returning None for ``None`` or 1).
    ``coordinator`` is rank 0's ``host:port`` (``tcp://`` init) or an
    init URL (``file://...``).  ``device`` says where the ranks keep
    their tensors and so picks the backend (:func:`rank_layout`); a
    CUDA rank's device becomes its current card."""
    if num_processes is None or num_processes <= 1:
        return None
    if coordinator is None:
        raise ValueError("distributed_init needs rank 0's host:port for "
                         f"{num_processes} processes")
    dev, backend = rank_layout(device, num_processes, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)
    return dev


def _world() -> int:
    """The process group's size: 1 when none was initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None,
              axis: str = "chains") -> Optional[DeviceMesh]:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all) of
    the process group (:func:`distributed_init`).  Without a group there
    is one rank and no mesh: asking for one rank returns None, which the
    engines and the placement functions take as a single process."""
    world = _world()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if not dist.is_initialized():
        return None
    return DeviceMesh(_device_type(), list(range(n)), mesh_dim_names=(axis,))


def make_mesh2(n_chain: int, n_dim: int,
               axes=("chains", "dim")) -> DeviceMesh:
    """A 2-D ``(chains, dim)`` mesh: chains split over rows of ranks and
    the parameter dimension over columns.  Placement only: the engines
    do not yet take a dim-split batch (they raise, naming
    ``DIM_SPLIT_ITEM``)."""
    world = _world()
    need = n_chain * n_dim
    if need > world:
        raise ValueError(f"requested {need} devices, have {world}")
    if not dist.is_initialized():
        return None
    return DeviceMesh(_device_type(),
                      torch.arange(need).reshape(n_chain, n_dim),
                      mesh_dim_names=tuple(axes))


def _block(n: int, parts: int, index: int, what: str):
    if n % parts:
        raise ValueError(f"{n} {what} do not split evenly over {parts} "
                         "ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def _chain_block(leaf, mesh: Optional[DeviceMesh], axis: str):
    leaf = torch.as_tensor(leaf)
    if leaf.ndim == 0 or mesh is None:
        return leaf
    return leaf[_block(leaf.shape[0], mesh.size(mesh.mesh_dim_names.index(
        axis)), mesh.get_local_rank(axis), "chains")]


def shard_chains(x, mesh: Optional[DeviceMesh], axis: str = "chains"):
    """This rank's block of the leading (chain) axis of a tensor, a numpy
    array or a tree of them; rank-0 leaves (and every leaf, without a
    mesh) come back whole.  Raises when the chains do not split evenly
    over the mesh."""
    return tree_map(lambda leaf: _chain_block(leaf, mesh, axis), x)


def shard_sampler_state(state, mesh: Optional[DeviceMesh],
                        axis: str = "chains"):
    """This rank's block of a ``SamplerState``: every leaf with a chain
    axis is cut to the rank's chains, the host iteration counter is
    kept."""
    return tree_map(lambda leaf: leaf if isinstance(leaf, int)
                    else _chain_block(leaf, mesh, axis), state)


def replicate(x, mesh: Optional[DeviceMesh]):
    """Every rank keeps the whole of ``x`` (as tensors)."""
    return tree_map(torch.as_tensor, x)


def shard_chains_dim(x, mesh: Optional[DeviceMesh],
                     axes=("chains", "dim")):
    """This rank's (row, column) block on a ``(chains, dim)`` mesh:
    ``[C, ..., D]`` leaves are cut along the chains and the last axis,
    ``[C]`` leaves along the chains, rank-0 leaves come back whole."""
    if mesh is None:
        return tree_map(torch.as_tensor, x)
    rows = mesh.size(mesh.mesh_dim_names.index(axes[0]))
    cols = mesh.size(mesh.mesh_dim_names.index(axes[1]))
    r, c = mesh.get_local_rank(axes[0]), mesh.get_local_rank(axes[1])

    def _put(leaf):
        leaf = torch.as_tensor(leaf)
        if leaf.ndim == 0:
            return leaf
        out = leaf[_block(leaf.shape[0], rows, r, "chains")]
        if leaf.ndim >= 2:
            out = out[..., _block(leaf.shape[-1], cols, c, "dimensions")]
        return out

    return tree_map(_put, x)


# ---------------------------------------------------------------------------
# what the engines need of a mesh
# ---------------------------------------------------------------------------

def split(mesh: Optional[DeviceMesh]) -> bool:
    """Whether ``mesh`` splits the chains over more than one rank; a
    2-D mesh raises, since no engine takes a dim-split batch yet."""
    if mesh is None:
        return False
    if mesh.ndim != 1:
        raise NotImplementedError(
            f"the engines split chains over a 1-D mesh; a {mesh.ndim}-D "
            f"mesh (the dim split) waits for {DIM_SPLIT_ITEM}")
    return mesh.size() > 1


def chain_block(mesh: Optional[DeviceMesh], C: int):
    """``(c0, C_total)``: this rank's ``C`` chains are chains ``c0 ..
    c0+C-1`` of ``C_total`` (every rank holds as many)."""
    if not split(mesh):
        return 0, C
    return mesh.get_local_rank() * C, mesh.size() * C


def _staged(x, group):
    """Gloo's collectives take host tensors here: a CUDA tensor goes
    through a host copy."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def gather_rows(x, mesh: Optional[DeviceMesh], dim: int = 0):
    """All-gather ``x`` along ``dim`` in rank order, so that every rank
    gets the whole batch's tensor (``x`` itself without a split)."""
    if not split(mesh):
        return x
    group = mesh.get_group()
    src = _staged(x.contiguous(), group)
    parts = [torch.empty_like(src) for _ in range(mesh.size())]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def reduce_int(x, mesh: Optional[DeviceMesh], op: str = "sum") -> int:
    """All-reduce a 0-dim integer tensor (or int) over the mesh with
    ``op`` (``"sum"``, ``"max"`` or ``"min"``) and return the host int;
    without a split, ``int(x)``."""
    if not split(mesh):
        return int(x)
    group = mesh.get_group()
    t = torch.as_tensor(x).to(torch.int64).reshape(1)
    t = t.cuda() if dist.get_backend(group) == "nccl" else t.cpu()
    dist.all_reduce(t, op=_OPS[op], group=group)
    return int(t)
