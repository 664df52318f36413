"""Static orbit-expansion schedules (replacements, built before the
loop, for the reference's runtime bookkeeping); the port's own copy of
``walnuts_tpu/sampler/plans.py``, numpy only.

The reference precomputes, per doubling depth ``i``, the exact ordered
list of U-turn checks a recursive subtree build would perform
(``subTreePlan``, ``WALNUTSpy/WALNUTS.py:20-41``) and then services
them at runtime with an id-keyed state stack that linearly searches for
free slots (``stateStore``, ``WALNUTS.py:48-88``).

Because the check sequence is fully determined by the depth, slot
lifetimes can be resolved before the orbit loop runs: this module
simulates the push / delete-range / read pattern once in Python and
emits flat numpy tables — one row per integration pair across the whole
orbit — that the step loop of :mod:`.transition` indexes with a host
step counter.  The runtime allocator disappears entirely; what remains
on the device is a fixed ``[C, capacity, D]`` slab pair written and read
at statically scheduled slots.

Flat step layout: step 0 is the depth-0 single macro step; steps
``1 .. 2^(M-1)-1`` are the integration pairs of depths ``1..M-1`` in
order.  Each pair integrates relative states ``(2j+1, 2j+2)`` of its
depth's new subtree, runs the adjacent U-turn check, then up to
``M-2`` statically scheduled "merge" checks that read earlier states
back from the slab (the check-only rows of ``WALNUTS.py:572-587``).
"""

from typing import NamedTuple

import numpy as np


def subtree_checks(nleaf: int):
    """Ordered (a, b) U-turn checks of a recursive subtree build over
    leaves ``1..nleaf`` (replicates ``WALNUTSpy/WALNUTS.py:22-41``)."""
    out = []

    def rec(a, b):
        if a != b:
            m = (a + b) // 2
            rec(a, m)
            rec(m + 1, b)
            out.append((a, b))

    rec(1, nleaf)
    return out


class _Pair(NamedTuple):
    depth: int
    rel1: int
    rel2: int
    slot1: int
    slot2: int
    post: list  # [(slot_lo, slot_hi, rel_lo, rel_hi)]
    last_of_depth: bool


def _simulate_depth(depth: int):
    """Simulate the reference's first-free slot allocator over one
    depth's check plan; returns pair ops with resolved slots and the
    peak number of simultaneously live slots."""
    nleaf = 2**depth
    checks = subtree_checks(nleaf)
    id2slot = {}
    next_free = 0
    free = []
    pairs = []
    peak = 0

    def alloc(i):
        nonlocal next_free, peak
        if free:
            s = min(free)
            free.remove(s)
        else:
            s = next_free
            next_free += 1
        id2slot[i] = s
        peak = max(peak, len(id2slot))
        return s

    cur = None
    for a, b in checks:
        if b - a == 1:
            s1 = alloc(a)
            s2 = alloc(b)
            cur = _Pair(depth, a, b, s1, s2, [], False)
            pairs.append(cur)
        else:
            for idx in range(a + 1, b):
                if idx in id2slot:
                    free.append(id2slot.pop(idx))
            cur.post.append((id2slot[a], id2slot[b], a, b))
    if pairs:
        pairs[-1] = pairs[-1]._replace(last_of_depth=True)
    return pairs, peak


class OrbitSchedule(NamedTuple):
    """Flat static tables driving the orbit-expansion loop.

    All arrays have leading length ``n_steps = 2^(M-1)`` (step 0 =
    depth 0).  ``post_*`` are padded to ``max_post`` entries per step.
    """

    m: int
    n_steps: int
    capacity: int
    max_post: int
    depth: np.ndarray          # [T] int32 depth of each step
    rel1: np.ndarray           # [T] int32 first new relative state id
    rel2: np.ndarray           # [T] int32 second new relative state id (0 at depth 0)
    slot1: np.ndarray          # [T] int32
    slot2: np.ndarray          # [T] int32
    last_of_depth: np.ndarray  # [T] bool
    is_depth0: np.ndarray      # [T] bool
    post_slot_lo: np.ndarray   # [T, max_post] int32 (slot of lower rel id)
    post_slot_hi: np.ndarray   # [T, max_post] int32
    post_valid: np.ndarray     # [T, max_post] bool


def build_schedule(m: int) -> OrbitSchedule:
    """Build the flat schedule for ``M = m`` doublings."""
    if m < 1:
        raise ValueError("M must be >= 1")
    rows = [
        _Pair(0, 1, 0, 0, 0, [], True)  # depth-0 single step
    ]
    capacity = 1
    for depth in range(1, m):
        pairs, peak = _simulate_depth(depth)
        capacity = max(capacity, peak)
        rows.extend(pairs)

    n = len(rows)
    max_post = max((len(r.post) for r in rows), default=0)
    max_post = max(max_post, 1)  # keep shapes non-degenerate

    sched = OrbitSchedule(
        m=m,
        n_steps=n,
        capacity=capacity,
        max_post=max_post,
        depth=np.array([r.depth for r in rows], np.int32),
        rel1=np.array([r.rel1 for r in rows], np.int32),
        rel2=np.array([r.rel2 for r in rows], np.int32),
        slot1=np.array([r.slot1 for r in rows], np.int32),
        slot2=np.array([r.slot2 for r in rows], np.int32),
        last_of_depth=np.array([r.last_of_depth for r in rows], bool),
        is_depth0=np.array([r.depth == 0 for r in rows], bool),
        post_slot_lo=np.zeros((n, max_post), np.int32),
        post_slot_hi=np.zeros((n, max_post), np.int32),
        post_valid=np.zeros((n, max_post), bool),
    )
    for t, r in enumerate(rows):
        for k, (slo, shi, _, _) in enumerate(r.post):
            sched.post_slot_lo[t, k] = slo
            sched.post_slot_hi[t, k] = shi
            sched.post_valid[t, k] = True
    assert sched.n_steps == 2 ** (m - 1)
    return sched
