"""The fused engine with its chains split over ranks, one card each:
``walnuts_tpu_torch.sampler.megakernel.run_walnuts_fused(mesh=)``.

The harness runs rank 0 in its own process on ``cuda:0``.  This entry
builds the round kernel there, then starts ranks 1 .. chips-1, each a
process of its own running this file, and joins all of them into one
process group (``walnuts_tpu_torch.parallel.distributed_init`` with
``device="cuda"``: rank r on card r, NCCL; on the CPU, gloo).  The
program's collectives (the stop test's all-reduce; the pooled warmup's
all-gather) run there.  A gloo group beside it carries the harness's
control: each call, the end of the window, and the counts and check
rows gathered to rank 0.

Each rank is ``entries/fused.py``'s entry (:class:`Rank`): it makes the
cell's start for all the chains from ``--seed`` and keeps its own block
(``parallel.shard_chains``): rank r runs global chains ``[r C/R, (r+1)
C/R)`` and its draws are those rows of a one-process run.

- ``warm()`` returns once every rank has made one short call of the
  cell's shape and the ranks have met.
- ``call()`` returns on rank 0 only once every rank's call has
  returned, so the window's wall covers every card's work.
- ``read(w)`` sets ``grads``, ``transitions``, ``it_range`` and
  ``failed`` over all ranks, ``C`` to all the chains, ``launches`` to
  rank 0's own count, ``ranks`` to each rank's ``(grads, transitions,
  C)``, and ``collectives`` to rank 0's ``parallel.mesh.
  chain_collectives`` in the window (None for a program without that
  counter).
- The check follows the chains ``check.Rows`` draws over all the global
  ids.  Each rank copies its own rows of them as the check's calls
  return and at the window's end; rank 0 gathers them in rank order and
  ``check.run_check`` compares them with the plain reference.  Beside
  it ``ranks_out_of_step`` counts the ranks that ran other rounds than
  rank 0, read the stop test another number of times, or made another
  number of collectives than reads of it: every rank has to take the
  same stop decisions from the same all-reduced count.

A rank that exits ends the run at once with exit code 5 and a line that
names it; so does a call or exchange that outlives ``LIMIT_S``, named.
A rank whose parent is gone exits.  No rank loads JAX: each reports the
modules it must not load, and rank 0 refuses the run if any did.

    python3 portbench/entries/fused_ranks.py --rank R --workload NAME
        --seed N --device cuda|cpu --init URL --root DIR

is how rank 0 starts rank R; it is not run by hand.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
if str(PORTBENCH) not in sys.path:
    sys.path.insert(0, str(PORTBENCH))

import inputs  # noqa: E402

fused = inputs.load_module(HERE / "fused.py", "portbench_entry_fused")

LIMIT_S = 300.0     # the longest a call or an exchange may take
POLL_S = 0.5        # how often the watch looks at the ranks
EXIT_CODE = 5       # a run the watch ended

# the control's commands, broadcast by rank 0
WARM, CALL, READ, EXIT = range(4)


def _host(rows):
    """A dict of check rows with every tensor copied to the host."""
    return {k: v.cpu() if hasattr(v, "cpu") else v for k, v in rows.items()}


def _cat(parts):
    """Check rows of the ranks, in rank order, joined along the chains."""
    import torch

    out = {}
    for k, v in parts[0].items():
        out[k] = (torch.cat([p[k] for p in parts]) if hasattr(v, "cpu")
                  else v)
    return out


def _collectives():
    """``parallel.mesh.chain_collectives`` (None for a program without
    that counter)."""
    from walnuts_tpu_torch.parallel import mesh

    return getattr(mesh, "chain_collectives", None)


class Rank(fused.Entry):
    """One rank's block of the cell's chains: ``entries/fused.py``'s
    entry over the whole batch's start and check rows, run on the
    rank's block of the chains (the check's sampled chains among them)
    with the chains mesh."""

    def __init__(self, cell, seed, dev):
        from walnuts_tpu_torch import parallel

        if (cell.run.get("warmup") or {}).get("pooled"):
            raise ValueError(f"{cell.name}: this entry checks fixed-tuning "
                             "and per-chain runs; pooled warmup over ranks "
                             "needs the batch's consensus rows in the check")
        super().__init__(cell, seed, dev)
        self.mesh = self.kw["mesh"] = parallel.make_mesh()
        self.whole = (self.q0, self.h, self.delta)
        self.q0, self.h, self.delta = parallel.shard_chains(self.whole,
                                                            self.mesh)
        C = self.q0.shape[0]
        c0, _ = parallel.chain_block(self.mesh, C)
        ids = self.rows.ids
        self.rows.ids = ids[(ids >= c0) & (ids < c0 + C)] - c0

    def warm(self):
        """``fused.Entry.warm``, and the stop test's reads and the
        collectives counted from 0; its reply is ``(0,)``."""
        from walnuts_tpu_torch.parallel import mesh

        super().warm()
        self.mk.stop_readbacks = 0
        if _collectives() is not None:
            mesh.chain_collectives = 0
        return (0,)

    def call(self):
        """The window's next call; its reply: the call's wall nanoseconds
        on this rank."""
        t0 = time.perf_counter_ns()
        super().call()
        return (time.perf_counter_ns() - t0,)

    def final(self):
        """The rank's counts after the window (``fused.Entry.read``'s),
        the stop test's reads and the collectives since the warm call,
        and its check rows of the window's end; its state is freed."""
        from run import forbidden_modules

        w = SimpleNamespace()
        self.read(w)
        self.release()
        out = vars(w)
        out.update(last=_host(self.rows.last), reads=self.mk.stop_readbacks,
                   collectives=_collectives(), forbidden=forbidden_modules())
        return out


class _Control:
    """The gloo group's exchanges, as every rank makes them."""

    def __init__(self, ranks):
        import torch
        import torch.distributed as dist

        self.dist, self.torch = dist, torch
        self.ranks = ranks
        self.group = dist.new_group(backend="gloo")

    def command(self, cmd=0):
        """Rank 0 sends ``cmd``; every other rank gets it."""
        t = self.torch.tensor([cmd], dtype=self.torch.int64)
        self.dist.broadcast(t, src=0, group=self.group)
        return int(t)

    def gather(self, obj, rank):
        """Every rank's ``obj`` at rank 0, in rank order (None elsewhere);
        pickled, so a few ms: the window's calls use :meth:`gather_ints`."""
        out = [None] * self.ranks if rank == 0 else None
        self.dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def gather_ints(self, values, rank):
        """Every rank's tuple of ints at rank 0, in rank order (None
        elsewhere)."""
        t = self.torch.tensor(values, dtype=self.torch.int64)
        out = ([self.torch.empty_like(t) for _ in range(self.ranks)]
               if rank == 0 else None)
        self.dist.gather(t, out, dst=0, group=self.group)
        return out and [tuple(int(v) for v in x) for x in out]


class _Watch(threading.Thread):
    """Rank 0's watch over the other ranks: a rank that exits while the
    run needs it, or an exchange that outlives ``LIMIT_S``, ends the
    process at once, every rank with it."""

    def __init__(self, procs, tmp):
        super().__init__(name="portbench-ranks-watch", daemon=True)
        self.procs, self.tmp = procs, tmp
        self.busy = None      # (what, start) of the exchange open
        self.closing = False  # the ranks may exit now
        self.done = threading.Event()

    def gone(self, wait=0.0):
        """``(rank, exit code)`` of the ranks that have exited, looked for
        during ``wait`` seconds until one has."""
        end = time.monotonic() + wait
        while True:
            out = [(r, p.returncode) for r, p in self.procs.items()
                   if p.poll() is not None]
            if out or time.monotonic() >= end:
                return out
            time.sleep(0.05)

    def run(self):
        while not self.done.wait(POLL_S):
            if not self.closing:
                for r, rc in self.gone():
                    abort(self.procs, self.tmp, f"rank {r} exited with code "
                          f"{rc} while the run needed it")
            busy = self.busy
            if busy and time.monotonic() - busy[1] > LIMIT_S:
                abort(self.procs, self.tmp,
                      f"{busy[0]} outlived {LIMIT_S:.0f} s")


def abort(procs, tmp, why):
    """End the run now, with every rank, naming why; the run's temporary
    directory goes too."""
    print(f"fused_ranks: {why}; ending the run", file=sys.stderr, flush=True)
    for p in procs.values():
        if p.poll() is None:
            p.kill()
    shutil.rmtree(tmp, ignore_errors=True)
    os._exit(EXIT_CODE)


class Entry:
    """Rank 0: the harness's entry (``entries/fused.py`` says its
    shape)."""

    def __init__(self, cell, seed, dev):
        from walnuts_tpu_torch import parallel

        if dev.type == "cuda":
            from walnuts_tpu_torch import _build
            _build.load()     # built once here, before the ranks load it
        self.cell, self.dev, self.seed = cell, dev, seed
        self.ranks = int(cell.chips)
        self.tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
        self.init = (Path(self.tmp) / "rendezvous").as_uri()
        try:
            out = sys.stderr.fileno()   # a rank's output goes to stderr
        except (AttributeError, OSError, ValueError):
            out = None
        self.procs = {}
        for r in range(1, self.ranks):
            self.procs[r] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank",
                 str(r), "--workload", cell.name, "--seed", str(seed),
                 "--device", dev.type, "--init", self.init, "--root",
                 str(cell.root)],
                cwd=str(cell.root), stdout=out)
        self.watch = _Watch(self.procs, self.tmp)
        self.watch.start()
        self._guard("joining the ranks", lambda: self._join(parallel, dev))
        self.check_calls = self.me.check_calls
        self.calls = 0
        self.first = self.last = None
        self.out_of_step = None
        self.call_ns = []   # each rank's own wall ns of each call

    def _join(self, parallel, dev):
        parallel.distributed_init(self.init, self.ranks, 0,
                                  device=dev.type)
        self.ctl = _Control(self.ranks)
        self.me = Rank(self.cell, self.seed, dev)

    def _guard(self, what, fn):
        """``fn()`` under the watch's limit; any error ends the run."""
        self.watch.busy = (what, time.monotonic())
        try:
            return fn()
        except BaseException:
            traceback.print_exc()
            # a rank that died breaks the collectives before it is reaped
            why = "".join(f"; rank {r} exited with code {rc}"
                          for r, rc in self.watch.gone(wait=2.0))
            abort(self.procs, self.tmp, f"{what} failed on rank 0{why}")
        finally:
            self.watch.busy = None

    def _ask(self, command, what, own, objects=False):
        """Every rank runs ``command``; rank 0 runs ``own()``.  Returns
        the ranks' replies in rank order: tuples of ints, or with
        ``objects`` any objects."""

        def exchange():
            self.ctl.command(command)
            mine = own()
            return (self.ctl.gather(mine, 0) if objects
                    else self.ctl.gather_ints(mine, 0))

        return self._guard(what, exchange)

    def warm(self):
        self._ask(WARM, "the warm call", self.me.warm)

    def call(self):
        k = self.calls
        replies = self._ask(CALL, f"call {k}", self.me.call)
        self.calls += 1
        if k == self.check_calls - 1:
            self.first = _cat(self._guard(
                "the check's rows", lambda: self.ctl.gather(
                    _host(self.me.rows.first), 0)))
        elif k >= self.check_calls:
            self.call_ns.append([ns for ns, in replies])

    def read(self, w):
        w.collectives = _collectives()
        ranks = self._ask(READ, "the window's counts", self.me.final,
                          objects=True)
        bad = {r: f["forbidden"] for r, f in enumerate(ranks)
               if f["forbidden"]}
        if bad:
            abort(self.procs, self.tmp,
                  f"ranks loaded what they must not: {bad}")
        own = ranks[0]
        for k in ("calls", "rounds", "launches", "segment_launches", "D",
                  "dg", "itemsize"):
            setattr(w, k, own[k])
        w.grads = sum(f["grads"] for f in ranks)
        w.transitions = sum(f["transitions"] for f in ranks)
        w.C = sum(f["C"] for f in ranks)
        w.it_range = (min(f["it_range"][0] for f in ranks),
                      max(f["it_range"][1] for f in ranks))
        w.failed = sum(f["failed"] for f in ranks)
        w.ranks = [(f["grads"], f["transitions"], f["C"]) for f in ranks]
        self.last = _cat([f["last"] for f in ranks])
        # every rank ran the rounds of rank 0, and made one collective a
        # read of the stop test (none where the program counts none)
        self.out_of_step = [
            r for r, f in enumerate(ranks)
            if f["rounds"] != own["rounds"] or f["reads"] != own["reads"]
            or f["collectives"] not in (None, f["reads"])]
        if self.call_ns:
            n = len(self.call_ns)
            ms = [1e-6 * sum(c[r] for c in self.call_ns) / n
                  for r in range(self.ranks)]
            lag = 1e-6 * sum(max(c) - min(c) for c in self.call_ns) / n
            print(f"fused_ranks: {n} calls at the round cap; each rank's own "
                  f"ms a call {[round(x, 3) for x in ms]}; the slowest rank "
                  f"{lag:.3f} ms behind the fastest a call", file=sys.stderr,
                  flush=True)

    def release(self):
        """The ranks leave the group and exit."""
        import torch.distributed as dist

        self.watch.closing = True

        def leave():
            self.ctl.command(EXIT)
            dist.destroy_process_group()
            for r, p in self.procs.items():
                if p.wait() != 0:
                    raise RuntimeError(f"rank {r} exited with code "
                                       f"{p.returncode}")

        self._guard("the ranks' exit", leave)
        self.watch.done.set()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self):
        """``check.run_check`` on every rank's rows, and
        ``ranks_out_of_step``: the ranks whose rounds, stop-test reads or
        collectives in the window differ from rank 0's rounds and reads,
        limit 0."""
        import check

        q0, h, delta = self.me.whole
        rows = check.Rows(self.cell, self.seed, h, delta, q0.shape[0])
        rows.first, rows.last = self.first, self.last
        out, correct, n = check.run_check(self.cell, rows, self.me.ref,
                                          self.me.whole, self.me.hseed)
        out["ranks_out_of_step"] = dict(
            value=len(self.out_of_step),
            limit=self.cell.run["check"]["limits"]["ranks_out_of_step"])
        return out, correct and check.passes(out["ranks_out_of_step"]), n


def control(cell, seed, dev, low):
    """The control's numbers for one seed, in one process: the check's
    chains are drawn over all the global ids, and the reference follows
    any chain by its id, so it is ``entries/fused.py``'s control at the
    cell's whole batch."""
    return fused.control(cell, seed, dev, low)


def _watch_parent():
    """Exit once the process that started this rank is gone."""
    parent = os.getppid()
    while os.getppid() == parent:
        time.sleep(POLL_S)
    os._exit(EXIT_CODE)


def worker(argv=None):
    """Rank ``--rank``: joins the group, makes its block and runs the
    commands rank 0 sends until ``EXIT``."""
    ap = argparse.ArgumentParser(description="one rank of fused_ranks")
    for name in ("--rank", "--seed"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--workload", "--device", "--init", "--root"):
        ap.add_argument(name, required=True)
    args = ap.parse_args(argv)
    threading.Thread(target=_watch_parent, daemon=True).start()
    sys.path.insert(0, args.root)
    import torch

    from cell import Cell
    from walnuts_tpu_torch import parallel

    cell = Cell(args.workload, root=args.root)
    dev = parallel.distributed_init(args.init, int(cell.chips), args.rank,
                                    device=args.device)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctl = _Control(int(cell.chips))
    me = Rank(cell, args.seed, dev)
    while True:
        command = ctl.command()
        if command == EXIT:
            break
        if command == WARM:
            ctl.gather_ints(me.warm(), args.rank)
        elif command == CALL:
            ctl.gather_ints(me.call(), args.rank)
            if me.calls == me.check_calls:
                ctl.gather(_host(me.rows.first), args.rank)
        else:
            ctl.gather(me.final(), args.rank)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker())
