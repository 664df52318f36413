"""Start a group of ranks on this host, one new process each.

``run_ranks(fn, n, args, device=...)`` starts ``n`` processes with
``torch.multiprocessing`` (the ``spawn`` method: each imports ``fn``'s
module, so a test process's JAX stays out of the ranks), joins them
into one process group over a file in a temporary directory
(:func:`.mesh.distributed_init`, with the ranks placed by ``device``),
calls ``fn(*args)`` in each and returns the results in rank order.
``fn`` is a module-level function; each rank's result, or its
traceback, travels pickled through a file in that directory, so
results should be host objects (numpy arrays, CPU tensors, numbers).

A rank that raises fails the call with every failed rank's traceback
(a rank's own error first shows which rank failed first); a group that
outlives ``timeout`` is killed and raises ``TimeoutError``.
"""

import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from ..utils.device import DEFAULT_DEVICE


def run_ranks(fn, n: int, args=(), *, timeout: float = 600.0,
              device=DEFAULT_DEVICE):
    """Run ``fn(*args)`` on ``n`` ranks of one process group and return
    their results in rank order.  ``device`` places the ranks
    (:func:`.mesh.rank_layout`: ``"cpu"``, ``"cuda:k"`` for ranks that
    share card k, ``"cuda"`` for a card per rank)."""
    with tempfile.TemporaryDirectory(prefix="walnuts_ranks_") as tmp:
        tmp = Path(tmp)
        procs = mp.start_processes(
            _rank, args=(n, str(tmp), str(device), fn, tuple(args)),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not procs.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} on {n} ranks "
                                       f"outlived {timeout} s")
        except ProcessException as e:
            failed = [f"rank {r}:\n{out}" for r, (ok, out) in
                      enumerate(_read(tmp, r) for r in range(n))
                      if ok is False]
            raise RuntimeError(f"{fn.__name__} failed on {n} ranks:\n"
                               + "\n".join(failed or [str(e)])) from e
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [_read(tmp, r)[1] for r in range(n)]


def _read(tmp: Path, rank: int):
    """``(ok, result or traceback)`` of a rank, ``(None, None)`` if it
    wrote none."""
    path = tmp / f"{rank}.out"
    if not path.exists():
        return None, None
    return pickle.loads(path.read_bytes())


def _rank(rank, n, tmp, device, fn, args):
    """One rank of :func:`run_ranks`."""
    from .mesh import distributed_init

    tmp = Path(tmp)
    distributed_init((tmp / "rendezvous").as_uri(), n, rank, device)
    try:
        out = (True, fn(*args))
    except BaseException:
        out = (False, traceback.format_exc())
        raise
    finally:
        part = tmp / f"{rank}.part"
        part.write_bytes(pickle.dumps(out))
        os.replace(part, tmp / f"{rank}.out")
        if dist.is_initialized():
            dist.destroy_process_group()
