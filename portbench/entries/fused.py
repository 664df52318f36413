"""The fused engine's entry: ``walnuts_tpu_torch.sampler.megakernel.
run_walnuts_fused``, every round in the hand-written round kernel.

A traffic file names its entry (``"entry": "fused"``); the harness
loads ``entries/<entry>.py`` and drives its ``Entry(cell, seed,
device)``: ``warm()`` once in set-up, ``call()`` until the window
closes (``calls`` counts them, the first ``check_calls`` being the
check's), ``read(w)`` into the window's record (``calls``, ``rounds``,
``launches``, ``segment_launches``, ``grads``, ``transitions``, ``C``,
``D``, ``dg``, ``itemsize``, ``it_range``, ``failed``), ``release()``
once the window's memory peak is read, and ``check()``, which returns
``({number: {value, limit}}, correct, draws compared)``.  A module
beside this one with an ``Entry`` of that shape and a ``control(cell,
seed, device, low)`` adds another entry.  Here each call resumes the
last one's state and the window's first calls are the check's
(:class:`check.Rows`).
"""

import torch

import check
import inputs


class Entry:
    def __init__(self, cell, seed, dev):
        import walnuts_tpu_torch as tw
        from walnuts_tpu_torch.sampler import megakernel, round_kernel

        if dev.type == "cuda":
            from walnuts_tpu_torch import _build
            _build.load()
        self.mk, self.rk = megakernel, round_kernel
        self.cell, self.dev = cell, dev
        self.ref = inputs.reference_target(cell)
        self.q0, self.h, self.delta = inputs.start(cell, self.ref, seed, dev)
        self.hseed = inputs.hash_seed(seed)
        self.kw = inputs.engine_kwargs(cell, tw, inputs.program_target(cell, tw),
                                       dev)
        self.rows = check.Rows(cell, seed, self.h, self.delta,
                               self.q0.shape[0])
        self.check_calls = self.rows.calls
        self.st, self.calls = None, 0

    def _run(self, rounds, state):
        return self.mk.run_walnuts_fused(
            self.hseed, self.q0, self.h, self.delta, mk_state=state,
            **dict(self.kw, rounds=int(rounds)))[-1]

    def warm(self):
        """One short call of the cell's shape from the start (the kernel's
        load, the allocator's pools, a graph capture on the external
        route); the launch counters start again from 0."""
        self._run(2 * self.mk.FLUSH_EVERY, None)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.rk.launches = self.rk.segment_launches = 0

    def call(self):
        k = self.calls
        rounds = self.rows.rounds(k) or self.kw["rounds"]
        self.rows.before_call(self.st)
        self.st = self._run(rounds, self.st)
        self.calls += 1
        self.rows.after_call(k, self.st)
        if int(self.st.it.min()) >= int(self.cell.run["num_iter"]):
            raise RuntimeError(
                f"{self.cell.name}: every chain reached num_iter inside the "
                "window; the traffic must give the window more work than it "
                "can finish")

    def read(self, w):
        """The window's counts: gradient evaluations and transitions
        (exact int64 sums of the engine's per-chain counters), the kernel
        launches, the shape, and the stored draws that are not finite."""
        st = self.st
        w.calls, w.rounds = self.calls, int(st.n)
        w.launches = self.rk.launches
        w.segment_launches = self.rk.segment_launches
        w.grads = int(st.grad_ct.to(torch.int64).sum())
        w.transitions = int(st.it.to(torch.int64).sum())
        w.C, w.D = st.qc.shape
        w.dg = st.samples.shape[2]
        w.itemsize = st.qc.element_size()
        w.it_range = (int(st.it.min()), int(st.it.max()))
        kept = st.samples[:min(w.it_range[1], st.samples.shape[0])]
        w.failed = int((~torch.isfinite(kept)).any(-1).sum())

    def release(self):
        self.rows.at_end(self.st)
        self.st = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return check.run_check(self.cell, self.rows, self.ref,
                               (self.q0, self.h, self.delta), self.hseed)


def control(cell, seed, dev, low):
    """The control's numbers for one seed: the reference in ``low`` in
    the program's place, judged as a run is (under pooled warmup with
    the tuning of the program's own check calls)."""
    want = inputs.DTYPES[cell.config["precision"]["dtype"]]
    e = Entry(cell, seed, dev)
    if e.rows.pooled:
        while e.calls < e.rows.calls:
            e.call()
    e.st = None
    rows = e.rows
    good = check.reference_rows(cell, e.ref, e.q0, e.h, e.delta, e.hseed,
                                rows.ids, want, rows.tuning)
    ctl = check.reference_rows(cell, e.ref, e.q0, e.h, e.delta, e.hseed,
                               rows.ids, low, rows.tuning)
    share, n = check.mismatch_share(cell, good, ctl)
    out = {"mismatch_share": share, "draws_compared": n}
    if "p2h_median_gap" in cell.run["check"]["limits"]:
        out["p2h_median_gap"] = check.p2h_median_gap(good, ctl)
    if rows.pooled:
        out["consensus_gap"] = max(check.consensus_gap(cell, r, p, low)
                                   for r, p in rows.periods)
    return out
