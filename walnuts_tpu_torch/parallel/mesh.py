"""Chain and column placement over ``torch.distributed`` ranks
(``walnuts_tpu/parallel/mesh.py``).

JAX places a ``[C, D]`` batch on a ``('chains',)`` or ``('chains',
'dim')`` mesh and lets GSPMD split every op.  Here each rank holds its
own block as plain local tensors (no DTensor: the round kernel takes raw
pointers through ctypes), and an engine given the mesh does what a
single process does not need.

On a 1-D mesh (chains over ranks) it

* keys its random draws by the global chain id (the threefry row
  window of the scan engine, the streaming engine and the isokinetic
  line, the hash's chain offset ``c0`` in the fused and streaming
  engines), so rank r's chains draw what rows ``[r C/R, (r+1) C/R)``
  draw in one process;
* makes the few cross-chain steps collective: the pooled warmup
  median (an all-gather in rank order) and the fused engine's stop test
  (an all-reduce).  Each such collective is counted in
  ``chain_collectives`` and timed as the span ``collective``
  (:mod:`..utils.trace`).

On a 2-D ``(chains, dim)`` mesh (:func:`make_mesh2`; every engine but
the fused one) a rank holds a block of chains and a window of columns
(:func:`dim_block`: blocks of ``ceil(D / n_dim)`` columns, the last one
shorter).  The chain steps above run over the ``chains`` axis; besides,
every sum over D becomes the rank's partial sum all-reduced over the
rank's dim group (the ranks that share its chains), the work GSPMD's
``psum`` does in JAX, and every draw over D is the rank's window of the
whole draw (:func:`col_window`).  Inside :func:`dim_split` the
collectives :func:`dim_sum`, :func:`dim_max`, :func:`dim_any`,
:func:`dim_all` and :func:`dim_gather` reduce over that group (outside
it, or on a mesh without a dim split, each returns its input); the ops,
the targets, the step kernels and the engines call them at every
reduction over D.  Every per-chain flag that a host loop reads comes
from them, so the ranks of a dim group take the same branches and make
the same sequence of collectives.

A mesh of one rank, or none, takes exactly the single-process path.
The backend follows where the ranks keep their tensors
(:func:`rank_layout`): ranks on the CPU, or ranks that share one card,
use gloo, which stages CUDA tensors through the host here; ranks with
a card each use NCCL.
"""

from contextlib import contextmanager
from contextvars import ContextVar
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils import trace
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.tree import tree_map

# The engine that takes a 1-D mesh only raises on a 2-D one, naming the
# ROADMAP item that its dim split waits for.
FUSED_DIM_SPLIT_ITEM = ("ROADMAP queue 1 item 4, the fused engine and the "
                        "CUDA round kernel under a dim split")


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
    """A 2-D ``(chains, dim)`` mesh: chains split over the mesh's first
    axis, the parameter dimension over its second (``axes`` names
    them).  Every engine but the fused one takes it; the fused engine
    raises on it."""
    world = _world()
    need = n_chain * n_dim
    if need > world:
        raise ValueError(f"requested {need} devices, have {world}")
    if not dist.is_initialized():
        return None
    return DeviceMesh(_device_type(),
                      torch.arange(need).reshape(n_chain, n_dim),
                      mesh_dim_names=tuple(axes))


# a mesh's chain axis is its first, its dim axis (2-D meshes) its second
_CHAINS, _DIM_AXIS = 0, 1


def chain_ranks(mesh: Optional[DeviceMesh]) -> int:
    """The number of ranks the chains are split over."""
    return 1 if mesh is None else mesh.size(_CHAINS)


def dim_ranks(mesh: Optional[DeviceMesh]) -> int:
    """The number of ranks the columns are split over (1 on a 1-D
    mesh)."""
    return 1 if mesh is None or mesh.ndim == 1 else mesh.size(_DIM_AXIS)


def _block(n: int, parts: int, index: int, what: str):
    if n % parts:
        raise ValueError(f"{n} {what} do not split evenly over {parts} "
                         "ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def _col_block(D: int, parts: int, index: int):
    width = -(-D // parts)
    if (parts - 1) * width >= D:
        raise ValueError(f"{D} columns in blocks of {width} leave a rank "
                         f"of {parts} without a column")
    d0 = index * width
    return d0, min(d0 + width, D)


def dim_block(mesh: Optional[DeviceMesh], D: int):
    """``(d0, d1)``: this rank's columns ``d0 .. d1-1`` of ``D`` on a
    ``(chains, dim)`` mesh, in blocks of ``ceil(D / n_dim)`` columns with
    the last one shorter (funnel(101) over two ranks: 51 + 50);
    ``(0, D)`` without a dim split."""
    if dim_ranks(mesh) == 1:
        return 0, int(D)
    return _col_block(int(D), mesh.size(_DIM_AXIS),
                      mesh.get_local_rank(_DIM_AXIS))


def _chain_block(leaf, mesh: Optional[DeviceMesh]):
    leaf = torch.as_tensor(leaf)
    if leaf.ndim == 0 or mesh is None:
        return leaf
    return leaf[_block(leaf.shape[0], chain_ranks(mesh),
                       mesh.get_local_rank(_CHAINS), "chains")]


def shard_chains(x, mesh: Optional[DeviceMesh], axis: str = "chains"):
    """This rank's block of the leading (chain) axis of a tensor, a numpy
    array or a tree of them, split over the mesh's first axis (``axis``,
    its name, is JAX's argument); rank-0 leaves (and every leaf, without
    a mesh) come back whole.  Raises when the chains do not split evenly
    over the mesh."""
    return tree_map(lambda leaf: _chain_block(leaf, mesh), x)


def shard_sampler_state(state, mesh: Optional[DeviceMesh],
                        axis: str = "chains"):
    """This rank's block of a ``SamplerState``: every leaf with a chain
    axis is cut to the rank's chains, the host iteration counter is
    kept."""
    return tree_map(lambda leaf: leaf if isinstance(leaf, int)
                    else _chain_block(leaf, mesh), state)


def replicate(x, mesh: Optional[DeviceMesh]):
    """Every rank keeps the whole of ``x`` (as tensors)."""
    return tree_map(torch.as_tensor, x)


def shard_chains_dim(x, mesh: Optional[DeviceMesh],
                     axes=("chains", "dim")):
    """This rank's (row, column) block on a ``(chains, dim)`` mesh:
    ``[C, ..., D]`` leaves are cut along the chains and to the columns
    of :func:`dim_block` on the last axis, ``[C]`` leaves along the
    chains, rank-0 leaves come back whole."""
    if mesh is None:
        return tree_map(torch.as_tensor, x)

    def _put(leaf):
        leaf = _chain_block(leaf, mesh)
        if leaf.ndim >= 2:
            d0, d1 = dim_block(mesh, leaf.shape[-1])
            leaf = leaf[..., d0:d1]
        return leaf

    return tree_map(_put, x)


# ---------------------------------------------------------------------------
# what the engines need of a mesh
# ---------------------------------------------------------------------------

def split(mesh: Optional[DeviceMesh]) -> bool:
    """Whether ``mesh`` splits the batch (its chains, its columns or
    both) over more than one rank."""
    return mesh is not None and mesh.size() > 1


def chains_only(mesh: Optional[DeviceMesh], item: str) -> bool:
    """:func:`split` for an engine that splits chains over a 1-D mesh
    only: a 2-D mesh raises, naming the ROADMAP ``item`` that its dim
    split waits for."""
    if mesh is not None and mesh.ndim != 1:
        raise NotImplementedError(
            f"this engine splits chains over a 1-D mesh; a {mesh.ndim}-D "
            f"mesh (the dim split) waits for {item}")
    return split(mesh)


def chain_block(mesh: Optional[DeviceMesh], C: int):
    """``(c0, C_total)``: this rank's ``C`` chains are chains ``c0 ..
    c0+C-1`` of ``C_total`` (every rank holds as many)."""
    if chain_ranks(mesh) == 1:
        return 0, C
    return mesh.get_local_rank(_CHAINS) * C, mesh.size(_CHAINS) * C


def _staged(x, group):
    """Gloo's collectives take host tensors here: a CUDA tensor goes
    through a host copy."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def _on_backend(t, group):
    """A new host tensor ``t`` where the group's collectives take it."""
    return t.cuda() if dist.get_backend(group) == "nccl" else t


chain_collectives = 0  # collectives made over a split chains axis


def _collective():
    """Count one collective over the chains axis and time it as the span
    ``collective`` (its enqueue and, where it has one, its blocking
    read)."""
    global chain_collectives
    chain_collectives += 1
    return trace.span("collective")


def gather_rows(x, mesh: Optional[DeviceMesh], dim: int = 0):
    """All-gather ``x`` along ``dim`` over the chains axis in rank
    order, so that every rank gets the whole batch's tensor (``x``
    itself without a chain split)."""
    if chain_ranks(mesh) == 1:
        return x
    with _collective():
        group = mesh.get_group(_CHAINS)
        src = _staged(x.contiguous(), group)
        parts = [torch.empty_like(src) for _ in range(mesh.size(_CHAINS))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(x.device)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def reduce_int(x, mesh: Optional[DeviceMesh], op: str = "sum") -> int:
    """All-reduce a 0-dim integer tensor (or int) over the chains axis
    with ``op`` (``"sum"``, ``"max"`` or ``"min"``) and return the host
    int; without a chain split, ``int(x)``.  Under NCCL the count goes
    to the card (a count made there stays there), the all-reduce is
    queued behind the work that makes it, and the host reads the result
    once; under gloo it goes through the host."""
    if chain_ranks(mesh) == 1:
        return int(x)
    with _collective():
        group = mesh.get_group(_CHAINS)
        dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        t = torch.as_tensor(x).to(device=dev, dtype=torch.int64,
                                  copy=True).reshape(1)
        dist.all_reduce(t, op=_OPS[op], group=group)
        return int(t)


# ---------------------------------------------------------------------------
# the dim group: the ranks that hold the same chains' other columns
# ---------------------------------------------------------------------------

class DimSplit(NamedTuple):
    """The active dim split: this rank holds columns ``d0 .. d1-1`` of
    ``D``, and ``group`` (of ``ranks`` ranks) holds the rest of its
    chains' columns."""

    group: object
    ranks: int
    d0: int
    d1: int
    D: int


# the enclosing dim_split's DimSplit (None outside one), per thread
_ACTIVE: ContextVar[Optional[DimSplit]] = ContextVar("dim_split",
                                                     default=None)


@contextmanager
def dim_split(mesh: Optional[DeviceMesh], D: int):
    """Within the block, the dim-group collectives reduce over
    ``mesh``'s dim axis for positions of ``D`` columns in all, of which
    this rank holds :func:`dim_block`'s; the targets take the rank's
    columns.  A mesh without a dim split (or ``None``) makes every
    collective an identity.  Yields the :class:`DimSplit` (or None)."""
    active = None
    if dim_ranks(mesh) > 1:
        d0, d1 = dim_block(mesh, D)
        active = DimSplit(mesh.get_group(_DIM_AXIS), mesh.size(_DIM_AXIS),
                          d0, d1, int(D))
    token = _ACTIVE.set(active)
    try:
        yield active
    finally:
        _ACTIVE.reset(token)


def current_dim_split() -> Optional[DimSplit]:
    """The :class:`DimSplit` of the enclosing :func:`dim_split`, or None."""
    return _ACTIVE.get()


def col_window(width: int):
    """``(D, cols)`` for a tensor of ``width`` columns: ``(width, None)``
    without a dim split; inside one, the whole width ``D`` and this
    rank's columns ``(d0, d1)`` of it, the ``cols=`` of a threefry draw
    over D."""
    active = _ACTIVE.get()
    if active is None:
        return int(width), None
    return active.D, (active.d0, active.d1)


def _dim_reduce(x, op):
    group = _ACTIVE.get().group
    t = _staged(x, group)
    t = (t.clone() if t is x else t).contiguous()  # reduced in place
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t.to(x.device)


def dim_sum(*parts):
    """The sums over the dim group of one or more partial sums of one
    shape (several go stacked through one all-reduce): a tensor for one
    part, a tuple for several.  The parts themselves without a dim
    split."""
    if _ACTIVE.get() is None:
        return parts[0] if len(parts) == 1 else parts
    if len(parts) == 1:
        return _dim_reduce(parts[0], "sum")
    return tuple(_dim_reduce(torch.stack(parts), "sum").unbind(0))


def dim_max(x):
    """The maximum of ``x`` over the dim group (``x`` without a split)."""
    return x if _ACTIVE.get() is None else _dim_reduce(x, "max")


def dim_any(b):
    """Whether any rank of the dim group has ``b`` (a bool tensor)."""
    if _ACTIVE.get() is None:
        return b
    return _dim_reduce(b.to(torch.uint8), "max").bool()


def dim_all(b):
    """Whether every rank of the dim group has ``b`` (a bool tensor)."""
    if _ACTIVE.get() is None:
        return b
    return _dim_reduce(b.to(torch.uint8), "min").bool()


def _gather_cols(x, group, n: int, D: int):
    width = -(-D // n)
    # blocks are full but the last: pad each to the full width, gather,
    # join and cut the last block's padding off the end
    src = x.new_zeros(x.shape[:-1] + (width,))
    src[..., :x.shape[-1]] = x
    src = _staged(src, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1)[..., :D].to(x.device)


def dim_gather(x):
    """The whole rows ``[..., D]`` of this rank's columns ``x`` within
    the active :func:`dim_split` (``x`` itself without one)."""
    active = _ACTIVE.get()
    if active is None:
        return x
    return _gather_cols(x, active.group, active.ranks, active.D)


def gather_cols(x, mesh: Optional[DeviceMesh]):
    """All-gather the column blocks ``[..., D_local]`` of a ``(chains,
    dim)`` mesh's dim group into whole rows ``[..., D]`` (``x`` itself
    without a dim split)."""
    if dim_ranks(mesh) == 1:
        return x
    group, n = mesh.get_group(_DIM_AXIS), mesh.size(_DIM_AXIS)
    w = _on_backend(torch.tensor([x.shape[-1]], dtype=torch.int64), group)
    widths = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(widths, w, group=group)
    return _gather_cols(x, group, n, int(sum(int(t) for t in widths)))
