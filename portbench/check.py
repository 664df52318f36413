"""The comparisons that decide ``correct`` for the fused engine's cells
(the entry ``entries/fused.py``).

The window's first calls run the check's rounds (``rounds``, split into
``calls`` equal calls, each resuming the last one's state), the rest
the cell's round cap.  What those calls returned is the timed path's
own output at the cell's full batch, and the plain reference can follow
any chain from the start on its own (its draws depend on its id alone).

``state``: the reference (:mod:`reference.walnuts` over the
configuration's reference target) follows a sample of the chains, drawn
from the seed, from the same start, tuning and hash seed for the same
rounds.  A chain matches when its integer state (orbit row, micro step,
refinement, phase, completed transitions, gradient evaluations; in
warmup the counts of its two P-squared estimators and the energy-range
estimator's marker positions) equals the reference's, its current and
trial positions, the orbit's two ends and the state it has selected so
far (in warmup also the energy-range estimator's marker heights and
first values) lie within
``atol + rtol * |reference|``, and so does every draw it completed (up
to ``draws``) in the program's ring; and when, at the end of the
window, the ring row of its last draw is the reference's summary of the
position the program drew.  The number compared is the share of
sampled chains that do not match.  Rounding differs between the kernel
and the reference; a chain whose energy error or U-turn test falls
within rounding of its threshold takes the other branch and goes its
own way, and that share of sound chains sets the lower reading of the
limit.

Under pooled warmup the batch consensus after each period couples the
chains, so the check's calls are one period each and the reference
takes each period's ``(H, delta)`` from the program's broadcast: the
sampled chains' estimators, which feed the consensus, are the
reference's own; ``p2h_median_gap`` compares their step-size
estimates by the median over the sampled chains (:func:`fields` says
why).  ``consensus_gap`` checks the stage this skips: after
each of the check's periods and at the window's end, the program's
``(H, delta)`` against the consensus worked out again from the whole
batch's estimators as the program holds them (:mod:`reference.
consensus`); the number is the largest relative gap.  Beside it the
count of chains that completed no transition in the window, whose limit
is 0.
"""

import torch

from inputs import DTYPES, sample_ids

INT_FIELDS = ("t", "k", "c_cur", "phase", "it", "grad_ct")
POS_FIELDS = ("qt", "qc", "q_prop", "qp", "qm")


def fields(cell):
    """``(integer fields, float fields, fields copied besides)``; an
    estimator's field is named ``p2h.q`` and so on.  The step-size
    estimator's values (``p2h``: the log of ``h / 2^c`` over the cube
    root of a step's largest energy change) are rounding where that
    change is a few units of the energies' last place, so its marker
    heights and positions are not compared chain by chain: its count
    is, and the median of its estimates over the sampled chains
    (:func:`p2h_median_gap`)."""
    ints, pos, extra = list(INT_FIELDS), list(POS_FIELDS), []
    wu = cell.run.get("warmup")
    if wu:
        ints += ["p2h.npush", "p2d.npush", "p2d.n"]
        pos += ["p2d.q", "p2d.x"]
        extra += ["p2h.q"]
        if not wu.get("pooled"):
            pos += ["h_cur", "delta_cur"]
    return ints, pos, extra


def _program_field(st, name):
    e, _, f = name.partition(".")
    return getattr(getattr(st, e), f) if f else getattr(st, e)


def _reference_field(s, name):
    e, _, f = name.partition(".")
    return s[e][f] if f else s[e]


class Rows:
    """What the check reads from the window's calls, copied as the calls
    return so that the program's banks can be freed."""

    def __init__(self, cell, seed, h, delta, C):
        chk = cell.run["check"]
        self.cell = cell
        self.calls = int(chk.get("calls", 1))
        self.per_call = int(chk["rounds"]) // self.calls
        self.pooled = bool((cell.run.get("warmup") or {}).get("pooled"))
        if self.pooled and self.per_call != 16:
            raise ValueError(f"{cell.name}: under pooled warmup each of the "
                             "check's calls is one period of 16 rounds")
        self.ids = sample_ids(seed, C, min(int(chk["chains"]), C)).to(h.device)
        self.tuning = []           # the program's (H, delta) after each period
        self.periods = []          # the batch's consensus rows, likewise
        self.prev = (h.clone(), delta.clone())
        self.first = None
        self.final = None
        self.last = None

    def rounds(self, k):
        """Rounds of the window's ``k``-th call if it is one of the
        check's, else None."""
        return self.per_call if k < self.calls else None

    def before_call(self, st):
        """Under pooled warmup, the ``(H, delta)`` a call starts from:
        the last call's is the final consensus's previous value (a median
        that is NaN at the end of a call was NaN all through it)."""
        if self.pooled and st is not None:
            self.prev = (st.h_cur.clone(), st.delta_cur.clone())

    def after_call(self, k, st):
        if k >= self.calls:
            return
        ids = self.ids
        if self.pooled:
            self.tuning.append((st.h_cur[ids].clone(),
                                st.delta_cur[ids].clone()))
            self.periods.append((consensus_rows(st), self.prev))
        if k == self.calls - 1:
            ints, pos, extra = fields(self.cell)
            out = {f: _program_field(st, f)[ids].clone()
                   for f in ints + pos + extra}
            n = min(int(self.cell.run["check"]["draws"]), st.samples.shape[0])
            out["draws"] = st.samples[:n, ids].transpose(0, 1).clone()
            out["ring_rows"] = st.samples.shape[0]
            self.first = out

    def at_end(self, st):
        """Each sampled chain's position at the end of the window and the
        ring row of its last draw, which the kernel summarised from that
        same position; ``stored`` is whether it stored that draw (no
        draw past ``num_iter`` is); under pooled warmup the batch's
        consensus rows."""
        num_iter = int(self.cell.run["num_iter"])
        ids = self.ids
        it = st.it[ids].long()
        row = st.samples[(it - 1).clamp(min=0) % st.samples.shape[0], ids]
        self.last = dict(stored=(it > 0) & (it <= num_iter),
                         qc=st.qc[ids].clone(), row=row.clone())
        if self.pooled:
            self.final = (consensus_rows(st), self.prev)


def reference_rows(cell, ref_target, q0, h, delta, hseed, ids, dtype,
                   tuning=()):
    """The reference's state of chains ``ids`` after the check's rounds,
    in ``dtype`` (with the configuration's slab dtype at the
    configuration's precision, and in ``dtype`` itself below it)."""
    from reference import walnuts

    chk, prec = cell.run["check"], cell.config["precision"]
    slab = DTYPES[prec["slab"]] if dtype == DTYPES[prec["dtype"]] else dtype
    smp = walnuts.Sampler(cell.config["sampler"], ref_target.logp_grad,
                          getattr(ref_target, cell.run["summary"]["reference"]),
                          cell.run["micro_unroll"], slab,
                          warmup=cell.run.get("warmup"))
    s, draws = walnuts.run(
        smp, q0[ids].to(dtype), h[ids].to(dtype), delta[ids].to(dtype),
        seed=hseed, cid=ids.long(), rounds=int(chk["rounds"]),
        n_draws=int(chk["draws"]), tuning=tuning)
    ints, pos, extra = fields(cell)
    out = {f: _reference_field(s, f) for f in ints + pos + extra}
    out["draws"] = draws
    return out


def mismatch_share(cell, ref, got, last=None, summary=None):
    """``(share of chains that do not match, draws compared)``; with
    ``last``, a chain also fails where the ring row of its last draw is
    not ``summary`` of its final position."""
    chk = cell.run["check"]
    rtol, atol = float(chk["rtol"]), float(chk["atol"])
    dev = ref["it"].device
    ints, pos, _ = fields(cell)

    def close(a, b):
        a, b = a.to(dev).double(), b.double()
        ok = (torch.abs(a - b) <= atol + rtol * torch.abs(b)) & \
            torch.isfinite(a)
        return ok.reshape(ok.shape[0], -1).all(-1)

    ok = torch.ones_like(ref["it"], dtype=torch.bool)
    for f in ints:
        ok = ok & (got[f].to(dev).long() == ref[f].long()).reshape(
            ok.shape[0], -1).all(-1)
    for f in pos:
        ok = ok & close(got[f], ref[f])
    K = min(ref["draws"].shape[1], got["draws"].shape[1])
    # draw i sits in ring row i until draw i + ring_rows overwrites it
    i = torch.arange(K, device=dev)[None]
    it = ref["it"].long()[:, None]
    due = (i < it) & (i + got.get("ring_rows", 1 << 30) >= it)
    d_ok = (torch.abs(got["draws"][:, :K].to(dev).double()
                      - ref["draws"][:, :K].double())
            <= atol + rtol * torch.abs(ref["draws"][:, :K].double())).all(-1)
    ok = ok & (d_ok | ~due).all(-1)
    n = int(due.sum())
    if last is not None:
        has = last["stored"].to(dev)
        want = summary(last["qc"].to(dev))
        ok = ok & (close(last["row"], want) | ~has)
        n += int(has.sum())
    return float((~ok).sum()) / ok.numel(), n


def p2h_median_gap(ref, got):
    """The gap, in log units, between the medians over the sampled
    chains of the program's and the reference's step-size estimates
    (each chain's middle marker, where its estimator holds more than ten
    values, as the consensus takes them): the consensus's ``H`` moves by
    that share."""
    from reference.consensus import nanmedian

    def med(rows):
        q = rows["p2h.q"][:, 2].double()
        ok = rows["p2h.npush"].to(q.device) > 10
        return nanmedian(torch.where(ok, q, float("nan")))

    a, b = med(got), med(ref).to(got["p2h.q"].device)
    if bool(torch.isnan(a) & torch.isnan(b)):
        return 0.0
    g = float(torch.abs(a - b))
    return g if g == g else float("inf")


def consensus_rows(st):
    """What the consensus check reads from the program's state."""
    return dict(it=st.it.clone(), np_h=st.p2h.npush.clone(),
                q_h=st.p2h.q[..., 2].clone(), np_d=st.p2d.npush.clone(),
                q_d=st.p2d.q[..., 2].clone(), h=st.h_cur.clone(),
                delta=st.delta_cur.clone())


def consensus_gap(cell, rows, prev, dtype):
    """The largest relative gap between the program's ``(H, delta)`` and
    the reference's from the same estimators, in ``dtype``; ``prev`` is
    the ``(H, delta)`` the period started from."""
    from reference.consensus import consensus

    wu = cell.run["warmup"]
    ph, pd = (p.to(dtype) for p in prev)
    h, d = consensus(rows["it"], rows["np_h"], rows["q_h"].to(dtype),
                     rows["np_d"], rows["q_d"].to(dtype),
                     int(wu["warmup_iter"]),
                     float(wu.get("adapt_delta_target", 0.6)), ph, pd)
    g = max(float((torch.abs(got.double() - want.double())
                   / torch.abs(want.double())).max())
            for got, want in ((rows["h"], h), (rows["delta"], d)))
    return g if g == g else float("inf")  # NaN: nothing to compare


def run_check(cell, rows, ref_target, inputs, hseed):
    """``({number: {value, limit}}, correct, draws compared)`` from what
    :class:`Rows` read."""
    chk = cell.run["check"]
    dtype = DTYPES[cell.config["precision"]["dtype"]]
    limits = chk["limits"]
    q0, h, delta = inputs
    ref = reference_rows(cell, ref_target, q0, h, delta, hseed, rows.ids,
                         dtype, rows.tuning)
    summary = getattr(ref_target, cell.run["summary"]["reference"])
    share, n_draws = mismatch_share(cell, ref, rows.first, rows.last,
                                    summary)
    out = {"mismatch_share": _num(share, limits["mismatch_share"])}
    if "p2h_median_gap" in limits:
        out["p2h_median_gap"] = _num(p2h_median_gap(ref, rows.first),
                                     limits["p2h_median_gap"])
    if chk.get("consensus"):
        gaps = [consensus_gap(cell, r, p, dtype) for r, p in rows.periods]
        gaps.append(consensus_gap(cell, *rows.final, dtype))
        out["consensus_gap"] = _num(max(gaps), limits["consensus_gap"])
        out["chains_without_draw"] = _num(
            int((rows.final[0]["it"] == 0).sum()),
            limits["chains_without_draw"])
    return out, all(passes(v) for v in out.values()), n_draws


def _num(value, limit):
    """A number compared, which passes at or below its limit."""
    return dict(value=value, limit=limit)


def passes(num):
    return num["value"] <= num["limit"]
