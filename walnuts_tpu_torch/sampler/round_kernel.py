"""One flush period of the fused engine: sixteen rounds of every chain
and the ring flush, as a hand-written CUDA kernel and its plain twin.

Replaces the TPU kernel ``walnuts_tpu/sampler/pallas_megakernel.py``
(``_make_kernel``, launched by ``run_walnuts_pallas``).  That kernel
held a block of 128 chains in VMEM and ran the shared round body on
``[128, 128]`` tiles; on the v5e scoped VMEM capped the block there and
it lost to XLA.  The CUDA kernel (``csrc/round_kernel.cu``) instead
gives each chain its own warps (:data:`WARPS_PER_CHAIN`): the D
coordinates spread over the chain's threads, the target's gradient (the
funnel's, the standard normal's or Stock-Watson's) is fused into the
leapfrog step, and D-reductions (kinetic energy, the funnel's sum of
squares, U-turn and merge dots) are warp shuffles, then across the
chain's warps a fixed-order sum through shared memory.  Each chain
follows its own control flow, so no chain waits on another's mask.

Stock-Watson's gradient is six scans over its series.  Its users run a
few hundred chains, so one warp per chain left most SMs idle and each
micro step one long dependent chain of latencies.  It runs one chain
per block of four warps: its trial vectors in registers (six values per
thread), the position and gradient rows in shared memory (in float32
the chain's whole block of ``vx`` too, for the launch), each thread two
series indices, each scan a warp scan joined across the four warps by a
prefix in a fixed order.  Its bound is the state bytes, 0.0144 ms per
launch at 256 chains, D = 756, float32.

What bounds it on the H100: latency at too few resident warps, then
state bytes.  A launch reads and writes each chain's state once, about
25 KB per chain at D=101, m=8 in float32 with the bf16 slab.  The kernel
keeps its registers per thread low enough for 24 resident warps per SM:
the trial vectors ``qt, vt, gt`` live in registers for the whole launch
(D <= 128), only the scalars the rounds' control flow and micro steps
read stay in registers, and the rest of a chain's scalars sits in
shared memory.  The micro steps touch no memory.

The state crosses the C interface as banks: per-chain float scalars as
rows of ``sf [NF, C]``, integers and flags as rows of ``si [NI, C]``
(int32), each with the kernel's register-resident ("hot") rows first;
the ``[C, D]`` vectors chain-major as ``vx [C, NV, Dp]``, each row
zero-padded to ``Dp = 32 * ceil(D / 32)`` so that one chain's vectors
are one aligned block; the slabs as ``[C, S, D]`` and the rings in the
engine's ``[R, C, dg]`` / ``[Rd, C, 24]`` layout.  The P2 warmup
estimators ride as extra rows.

Every target runs through the kernel on the card.  A target without a
fused gradient (any target without a ``kernel_id``: the other analytic
targets, every target a user writes, and a Stock-Watson series longer
than ``SW_TMAX``) runs the kernel's external-gradient instantiation:
its period is ``16 * micro_unroll + 1`` launches of one segment each,
from one gradient point to the next, and between two launches the
target's own ``logp_grad`` runs once, on every chain's position at that
point (:func:`_run_segments`).  The JAX round body evaluates the
gradient once per micro step for every chain, masked or not, so the
points are the same for all chains and the result is the plain twin's.
The host queues a period's launches and torch calls once, captured as a
CUDA graph, and replays that graph for every period of the same banks
and spec; the kernel reads the period's first round from a device int32
that the host writes before each replay.  A ``logp_grad`` that cannot
be captured (it waits for the card, e.g. through ``.item()``) runs the
same segments eagerly, with a warning.  :data:`segment_launches` counts
the segment launches.  Nothing falls back to the plain twin:
``megakernel.run_walnuts_fused_plain(device=...)`` runs it on the card
only when the caller asks for it by name.

The kernel stores three summaries itself (the identity, ``omega_sumsq``
and Stock-Watson's, the last for the series it fuses).  For any other
summary, the kernel stores the drawn positions in a two-row staging ring
and torch maps the user's summary over the rows each period staged
(:func:`defer_summary`, :func:`summarize`).
"""

import copy
import ctypes
import math
import warnings
import weakref
from typing import NamedTuple, Optional

import torch

from ..targets.analytic import omega_sumsq
from ..utils import trace
from ..utils.p2 import P2State
from .driver import WarmupConfig
from .megakernel import (FLUSH_EVERY, STOP_MODES, MState, dtype_consts,
                         flush, make_hash_draw, make_round_body, protocol,
                         slab_dtype)
from .transition import WalnutsConfig

# ---------------------------------------------------------------------------
# bank layout (mirrored by the X-macro lists in csrc/round_kernel.cu)
# ---------------------------------------------------------------------------

# The kernel keeps the *_HOT fields in registers and the rest of a
# chain's scalars in shared memory; each bank lists its hot rows first.
F_HOT = ("h_loc", "lpt", "ht", "dht", "fint")
F_FIELDS = F_HOT + (
    "h_cur", "delta_cur", "lps", "h0s", "lpa", "ha", "dha", "lpp", "hp",
    "lpm", "hm", "lpc", "lp_prop", "lp_prop_last", "mscale", "lwt_sum_f",
    "lwt_sum_b", "w_new_sum", "w_old_sum", "idx_time", "index_stat",
    "index_stat_old", "time_f", "time_b", "orbit_len", "orbit_len_sam",
    "h_min", "h_max", "lwt_min", "lwt_max",
)
I_HOT = ("t", "it", "phase", "c_cur", "k")
I_FIELDS = I_HOT + (
    "i_f", "c_sim", "nev_f", "nev_b",
    "sel_l", "sel_l_old", "a_abs", "b_abs", "stop_code",
    "n_doubl_sampled", "n_doubl_computed", "max_f_int", "max_b_int",
    "neval_f", "neval_b", "if_min", "if_max", "c_min_d", "c_max_d",
    "n_states", "n_if_neq_ib", "n_if_zero", "grad_ct", "prow0",
    "prow1",
)
B_HOT = ("second", "coarse", "depth_done")
B_FIELDS = B_HOT + ("both_ends_passive", "pend0", "pend1")
V_FIELDS = (
    "qs", "vs", "gs", "qt", "vt", "gt", "qa", "va", "ga", "q1", "v1",
    "qp", "vp", "gp", "qm", "vm", "gm", "qc", "gc", "q_prop", "g_prop",
    "q_prop_last", "g_prop_last",
)
P2_F_ROWS = 11   # x[5], q[5], p
P2_I_ROWS = 6    # npush, n[5]
I_XI = len(I_FIELDS)
I_BOOL = I_XI + 1
I_P2H = I_BOOL + len(B_FIELDS)
I_P2D = I_P2H + P2_I_ROWS
NI = I_P2D + P2_I_ROWS


def padded(D: int) -> int:
    """Row length of the vector bank: D rounded up to whole warps."""
    return 32 * -(-D // 32)


class Layout(NamedTuple):
    """Row offsets of ``sf`` for a summary width ``dg``."""
    pgen0: int
    pgen1: int
    pdiag0: int
    pdiag1: int
    p2h: int
    p2d: int
    nf: int


def layout(dg: int) -> Layout:
    base = len(F_FIELDS)
    p2h = base + 2 * dg + 48
    return Layout(base, base + dg, base + 2 * dg, base + 2 * dg + 24,
                  p2h, p2h + P2_F_ROWS, p2h + 2 * P2_F_ROWS)


class Banks(NamedTuple):
    sf: torch.Tensor       # [NF, C] run dtype
    si: torch.Tensor       # [NI, C] int32
    vx: torch.Tensor       # [C, NV, Dp] run dtype, zero past D
    slab_q: torch.Tensor   # [C, S, D] slab dtype
    slab_v: torch.Tensor
    samples: torch.Tensor  # [R, C, dg]
    diags: torch.Tensor    # [Rd, C, 24]


def pack(st: MState) -> Banks:
    """Engine state -> freshly allocated banks."""
    xi = st.xi_bits
    xi32 = torch.where(xi >= 2 ** 31, xi - 2 ** 32, xi).to(torch.int32)
    f_rows = [getattr(st, f) for f in F_FIELDS]
    f_rows += list(st.pgen0.T) + list(st.pgen1.T)
    f_rows += list(st.pdiag0) + list(st.pdiag1)
    i_rows = [getattr(st, f) for f in I_FIELDS] + [xi32]
    i_rows += [getattr(st, f).to(torch.int32) for f in B_FIELDS]
    C, D = st.qc.shape
    vx = st.qc.new_zeros((C, len(V_FIELDS), padded(D)))
    vx[:, :, :D] = torch.stack([getattr(st, f) for f in V_FIELDS], dim=1)
    for p2 in (st.p2h, st.p2d):
        f_rows += list(p2.x.T) + list(p2.q.T) + [p2.p]
    for p2 in (st.p2h, st.p2d):
        i_rows += [p2.npush] + list(p2.n.T)
    return Banks(
        sf=torch.stack(f_rows),
        si=torch.stack(i_rows),
        vx=vx,
        slab_q=st.slab_q.clone(memory_format=torch.contiguous_format),
        slab_v=st.slab_v.clone(memory_format=torch.contiguous_format),
        samples=st.samples.clone(memory_format=torch.contiguous_format),
        diags=st.diags.clone(memory_format=torch.contiguous_format),
    )


def unpack(b: Banks, n: int) -> MState:
    """Banks -> engine state at absolute round ``n``.  Float and integer
    fields and the vectors are views into the banks (writing one writes
    the bank); the flags and ``xi_bits`` are converted copies."""
    dg = b.samples.shape[2]
    D = b.slab_q.shape[2]
    lay = layout(dg)
    d = {f: b.sf[i] for i, f in enumerate(F_FIELDS)}
    d.update({f: b.si[i] for i, f in enumerate(I_FIELDS)})
    d["xi_bits"] = b.si[I_XI].to(torch.int64) & 0xFFFFFFFF
    d.update({f: b.si[I_BOOL + j] != 0 for j, f in enumerate(B_FIELDS)})
    d.update({f: b.vx[:, i, :D] for i, f in enumerate(V_FIELDS)})
    d["pgen0"] = b.sf[lay.pgen0:lay.pgen0 + dg].T
    d["pgen1"] = b.sf[lay.pgen1:lay.pgen1 + dg].T
    d["pdiag0"] = b.sf[lay.pdiag0:lay.pdiag0 + 24]
    d["pdiag1"] = b.sf[lay.pdiag1:lay.pdiag1 + 24]
    for name, fo, io in (("p2h", lay.p2h, I_P2H), ("p2d", lay.p2d, I_P2D)):
        d[name] = P2State(npush=b.si[io], x=b.sf[fo:fo + 5].T,
                          q=b.sf[fo + 5:fo + 10].T, n=b.si[io + 1:io + 6].T,
                          p=b.sf[fo + 10])
    d.update(n=n, slab_q=b.slab_q, slab_v=b.slab_v, samples=b.samples,
             diags=b.diags)
    return MState(**d)


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

class RoundSpec(NamedTuple):
    """What a flush period runs: the static arguments of
    ``run_walnuts_fused``, the int32 hash seed and the global id ``c0``
    of the banks' first chain (its rank's offset when chains are split
    over ranks)."""
    target: object
    cfg: WalnutsConfig
    warmup: Optional[WarmupConfig]
    stop_mode: str
    num_iter: int
    micro_unroll: int
    seed: int
    c0: int = 0


launches = 0  # fused-gradient kernel launches made by run_rounds
segment_launches = 0  # external-gradient segment launches (see _run_segments)
graph_captures = 0  # periods of segments captured as a CUDA graph
eager_periods = 0  # periods run eagerly: the target's logp_grad was not
#                    capturable


def run_rounds(b: Banks, n: int, spec: RoundSpec):
    """Advance every chain by one flush period (rounds ``n .. n+15``)
    and flush the rings, in place.  CUDA banks launch the kernel (one
    launch, or the external-gradient segments) or raise; CPU banks run
    the plain twin."""
    if b.vx.is_cuda:
        _launch(b, n, spec)
    elif b.vx.device.type == "cpu":
        run_rounds_plain(b, n, spec)
    else:
        raise ValueError(f"no round kernel for device {b.vx.device}")


def run_rounds_plain(b: Banks, n: int, spec: RoundSpec):
    """The kernel's plain torch twin: sixteen plain round bodies and a
    flush, written back into the banks."""
    st = unpack(b, n)
    C, D = st.qc.shape
    cid = torch.arange(spec.c0, spec.c0 + C, device=st.qc.device)
    draw = make_hash_draw(spec.seed, cid, D, st.qc.dtype)
    body = make_round_body(target=spec.target, cfg=spec.cfg,
                           warmup=spec.warmup, stop_mode=spec.stop_mode,
                           num_iter=spec.num_iter,
                           micro_unroll=spec.micro_unroll)
    for r in range(FLUSH_EVERY):
        st = body(st, draw(n + r))
    new = pack(flush(st))
    for dst, src in zip(b, new):
        dst.copy_(src)


class _RoundParams(ctypes.Structure):
    """Mirror of ``struct RoundParams`` in ``csrc/round_kernel.cu``."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in
         ("sf", "si", "vx", "slab_q", "slab_v", "samples", "diags", "y")]
        + [(f, ctypes.c_double) for f in
           ("s_lo", "s_2sc", "p0", "lp_c", "lp_f", "thresh", "scale",
            "log_scale", "half_log2pi", "half_k", "half_k_log2pi",
            "scale_sq", "delta_target", "half_inn_log2pi",
            "half_obs_log2pi", "three_log2pi")]
        + [(f, ctypes.c_int) for f in
           ("C", "D", "S", "dg", "R", "Rd", "T_rows", "min_c", "max_c",
            "proto_d", "stop_mode", "num_iter", "micro_unroll", "nbase",
            "seed", "warmup", "adapt_h", "adapt_delta", "pooled",
            "warmup_iter", "target", "gen", "precision", "sw_T",
            "sw_proper", "c0", "seg")]
        + [(f, ctypes.c_void_p) for f in ("xq", "xlp", "xg", "xn")])


# the targets whose gradient the kernel fuses, by kernel_id
KERNEL_TARGETS = {"funnel": 0, "std_gauss": 1, "stock_watson": 2}
EXTERNAL = 3  # the instantiation that takes any target's torch gradient
INSTANTIATIONS = dict(KERNEL_TARGETS, external=EXTERNAL)
SW_TMAX = 256  # Stock-Watson series the kernel fuses: 2 indices per thread
# Warps per chain of each instantiation, and threads per block (four
# one-warp chains, or one chain): the kernel's launch geometry
# (``csrc/round_kernel.cu``: wpc_for, block_threads, launch).
WARPS_PER_CHAIN = {"funnel": 1, "std_gauss": 1, "stock_watson": 4,
                   "external": 1}
THREADS = 128


def launch_geometry(target: str, C: int):
    """``(threads per block, blocks)`` of a launch of the instantiation
    ``target`` (an ``INSTANTIATIONS`` key) over ``C`` chains."""
    wpc = WARPS_PER_CHAIN[target]
    threads = THREADS if wpc == 1 else 32 * wpc
    return threads, -(-C * 32 * wpc // threads)


def _summary_id(target):
    """The kernel's id of ``target``'s summary, or None if it has none."""
    gen = target._generated
    if gen is None:
        return 0
    if gen is omega_sumsq:
        return 1
    if (_target_id(target, target.dim) == KERNEL_TARGETS["stock_watson"]
            and getattr(gen, "kernel_summary", None) == "stock_watson"):
        return 2
    return None


def _gen_id(target):
    gid = _summary_id(target)
    if gid is not None:
        return gid
    raise NotImplementedError(
        f"the CUDA round kernel stores the identity, omega_sumsq or "
        f"Stock-Watson summary, not {target._generated!r}; "
        "run_walnuts_fused maps other summaries in torch over the positions "
        "the kernel stores (defer_summary); in the kernel they wait for "
        "ROADMAP queue 2")


def _target_id(target, D):
    """The instantiation that runs ``target`` at dimension ``D``: its
    fused gradient's id (Stock-Watson's for series of 3 to ``SW_TMAX``
    rows at D = 3T), else ``EXTERNAL``."""
    tid = KERNEL_TARGETS.get(target.kernel_id, EXTERNAL)
    if tid == KERNEL_TARGETS["stock_watson"]:
        T = target.kernel_args["T"]
        if not (3 <= T <= SW_TMAX and 3 * T == D):
            return EXTERNAL
    return tid


def check_card(spec: RoundSpec) -> bool:
    """Whether the kernel stores ``spec``'s summary itself (True), or
    needs it mapped in torch (False: :func:`defer_summary`); decided
    from the spec alone, before any launch.  Every target runs on the
    card: with its fused gradient, or through the external-gradient
    segments (:func:`_target_id`)."""
    return _summary_id(spec.target) is not None


def defer_summary(st: MState, target):
    """The kernel's side of a summary it does not store:
    ``(target', st')``, where ``target'`` is ``target`` with the identity
    summary and ``st'`` holds two-row staging rings of positions in
    place of ``st``'s samples (the pending slots, empty between
    periods, are resized to match).  A period stages at most two draws
    per chain (a chain with both slots full starts no transition), at
    rows ``it % 2``; :func:`summarize` maps them into the real ring."""
    ident = copy.copy(target)
    ident._generated = None
    C, D = st.qc.shape
    z = st.qc.new_zeros((C, D))
    return ident, st._replace(samples=st.qc.new_zeros((2, C, D)),
                              pgen0=z, pgen1=z.clone())


def summarize(ring, stage, it0, it1, target, stop_mode: str, num_iter: int):
    """Map ``target``'s summary over the draws one period staged and
    write them into ``ring [R, C, dg]`` at the rows the kernel's flush
    would: chain c staged its draws ``it0[c] ..`` (at most two, fewer
    than ``it1[c]``; under ``min_per_chain`` only those before
    ``num_iter``), draw i at ``stage[i % 2, c]`` and ``ring[i % R, c]``.
    No host sync: rows a chain did not stage keep their values."""
    R, C = ring.shape[:2]
    dev = ring.device
    i = it0.long() + torch.arange(2, device=dev)[:, None]   # [2, C]
    ok = i < it1
    if stop_mode == "min_per_chain":
        ok = ok & (i < num_iter)
    cid = torch.arange(C, device=dev).expand(2, C)
    g = target.generated(stage[i % 2, cid]).to(ring.dtype)  # [2, C, dg]
    ok = ok[..., None]
    if R == 1:  # both draws land on the one row; the later one stays
        ring[0] = torch.where(ok[1], g[1], torch.where(ok[0], g[0], ring[0]))
    else:
        row = i % R
        ring[row, cid] = torch.where(ok, g, ring[row, cid])


def _params(b: Banks, n: int, spec: RoundSpec) -> _RoundParams:
    """The launch struct of a period from round ``n``.  ``EXTERNAL``
    leaves ``nbase`` at 0 and reads the round from ``xn`` on the device
    (:func:`_run_segments`), so its struct does not depend on ``n``."""
    tgt, cfg, wu = spec.target, spec.cfg, spec.warmup
    NF, C = b.sf.shape
    S, D = b.slab_q.shape[1:]
    tgt_id = _target_id(tgt, D)
    dg = b.samples.shape[2]
    dtype = b.vx.dtype
    proto_d, min_c, max_c = protocol(cfg)
    lp_c, lp_f, thresh = dtype_consts(cfg, dtype)
    scale = tgt.kernel_param if tgt.kernel_id == "funnel" else 1.0
    log_2pi = math.log(2.0 * math.pi)
    k = D - 1
    s_sc = cfg.step_size_rand_scale
    y_ptr, sw_T, sw_proper = None, 0, 0
    if tgt_id == KERNEL_TARGETS["stock_watson"]:
        sw_T, sw_proper = tgt.kernel_args["T"], int(tgt.kernel_args["proper"])
        y_ptr = tgt.kernel_args["y"](b.vx).data_ptr()
    n_inn = 3 * sw_T - 4
    return _RoundParams(
        *(t.data_ptr() for t in b), y_ptr,
        1.0 - s_sc, 2.0 * s_sc, cfg.igr.r2p_prob0, lp_c, lp_f, thresh,
        scale, math.log(scale), 0.5 * log_2pi, 0.5 * k, 0.5 * k * log_2pi,
        scale ** 2, wu.adapt_delta_target if wu else 0.0,
        0.5 * n_inn * log_2pi, 0.5 * sw_T * log_2pi, 3.0 * log_2pi,
        C, D, S, dg, b.samples.shape[0], b.diags.shape[0],
        2 ** (cfg.m - 1), min_c, max_c, int(proto_d),
        STOP_MODES.index(spec.stop_mode), spec.num_iter, spec.micro_unroll,
        0 if tgt_id == EXTERNAL else n, spec.seed, int(wu is not None),
        int(bool(wu and wu.adapt_h)),
        int(bool(wu and wu.adapt_delta)), int(bool(wu and wu.pooled)),
        wu.warmup_iter if wu else 0,
        tgt_id, _gen_id(tgt),
        0 if dtype == torch.float64 else 1, sw_T, sw_proper, spec.c0)


def _check(b: Banks):
    dev = b.vx.device
    C, S, D = b.slab_q.shape
    dtype = b.vx.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"round kernel runs float32 or float64, not {dtype}")
    dg = b.samples.shape[2]
    want = {
        "sf": ((layout(dg).nf, C), dtype),
        "si": ((NI, C), torch.int32),
        "vx": ((C, len(V_FIELDS), padded(D)), dtype),
        "slab_q": ((C, S, D), slab_dtype(dtype)),
        "slab_v": ((C, S, D), slab_dtype(dtype)),
        "samples": ((b.samples.shape[0], C, dg), dtype),
        "diags": ((b.diags.shape[0], C, 24), dtype),
    }
    for name, (shape, dt) in want.items():
        t = getattr(b, name)
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"bank {name}: want {shape} {dt} on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"bank {name} must be contiguous")


class LaunchError(RuntimeError):
    """The CUDA runtime refused a launch of the round kernel."""


def _launch(b: Banks, n: int, spec: RoundSpec, graph: bool = True):
    """One period on CUDA banks: one launch of a fused-gradient
    instantiation, or the external-gradient segments (graphed unless
    ``graph`` is False, which runs them eagerly)."""
    global launches
    from .. import _build

    _check(b)
    params = _params(b, n, spec)
    fn = _build.load().walnuts_round_launch
    fn.argtypes = [ctypes.POINTER(_RoundParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(b.vx.device):

        def launch():
            # the current stream: torch's capture stream under a capture
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(ctypes.byref(params), ctypes.c_void_p(stream))
            if err != 0:
                raise LaunchError(
                    f"round kernel launch failed (target {params.target}, "
                    f"segment {params.seg}): cudaError {err}")

        if params.target == EXTERNAL:
            _run_segments(b, n, params, spec, launch, graph)
        else:
            launch()
            launches += 1


class _Period(NamedTuple):
    """A period of external-gradient segments as the cache keeps it: its
    CUDA graph (None where the target's ``logp_grad`` could not be
    captured: the segments then run eagerly), and the query and round
    base tensors whose addresses the graph holds."""
    graph: Optional[object]
    query: torch.Tensor
    nbase: torch.Tensor
    target: object  # held, so that the key's id(target) stays its own


_graphs = {}  # _graph_key -> _Period; emptied by release_graphs
_warned = weakref.WeakSet()  # targets warned of a failed capture


def _graph_key(params: _RoundParams, target):
    """What a captured period depends on: every field of its launch
    struct (the banks' addresses; C, D and the dtype; the config's
    constants and the rings' shapes; micro_unroll, stop_mode, num_iter,
    the warmup, seed and c0), which for ``EXTERNAL`` holds no round,
    and the target, by identity.  ``params`` is fresh from
    :func:`_params` (segment 0, no exchange pointers)."""
    return bytes(params), id(target)


def release_graphs():
    """Free every cached period graph and its memory pool
    (``megakernel._run`` calls this when it returns)."""
    _graphs.clear()


def _run_segments(b: Banks, n: int, params: _RoundParams, spec: RoundSpec,
                  launch, graph: bool = True):
    """One period of the external-gradient instantiation from round
    ``n`` (:func:`_queue_period`).  With ``graph``, the period's work is
    captured once per :func:`_graph_key` and replayed; the host writes
    ``n`` to the device round base before each replay.  A target whose
    ``logp_grad`` cannot be captured runs the same work eagerly (a
    warning once per target; :data:`eager_periods`).  Nothing waits for
    the card."""
    global segment_launches, eager_periods
    C, D = b.vx.shape[0], b.slab_q.shape[2]
    if graph:
        key = _graph_key(params, spec.target)
        per = _graphs.get(key)
        if per is None:
            with trace.span("capture"):
                per = _graphs[key] = _capture_period(b, params, spec, launch)
    else:
        per = _Period(None, b.vx.new_empty((C, D)),
                      torch.empty(1, dtype=torch.int32, device=b.vx.device),
                      spec.target)
    per.nbase.fill_(n)
    if per.graph is not None:
        per.graph.replay()
    else:
        _queue_period(params, spec, per.query, per.nbase, launch)
        if graph:  # its capture failed
            eager_periods += 1
    segment_launches += FLUSH_EVERY * spec.micro_unroll + 1


def _queue_period(params: _RoundParams, spec: RoundSpec, query, nbase,
                  launch):
    """Queue one period on the current stream: ``16 * micro_unroll + 1``
    segment launches, and between two of them one call of
    ``spec.target.logp_grad`` on ``query [C, D]``, which the previous
    segment filled with the positions at the period's next gradient
    point.  The next segment reads its result; the kernel reads the
    period's first round from ``nbase``."""
    params.xq, params.xn = query.data_ptr(), nbase.data_ptr()
    params.xlp = params.xg = None
    last = FLUSH_EVERY * spec.micro_unroll
    for seg in range(last + 1):
        params.seg = seg
        launch()
        if seg < last:
            # lp and g stay referenced until the next launch is queued
            lp, g = _gradient(spec.target, query)
            params.xlp, params.xg = lp.data_ptr(), g.data_ptr()


def _capture_period(b: Banks, params: _RoundParams, spec: RoundSpec,
                    launch) -> _Period:
    """Capture one period of :func:`_queue_period` as a CUDA graph, on
    a query and round base allocated first; the query starts as the
    chains' trial positions.  No segment runs, so no chain moves.  A
    capture that fails gives a period without a graph (a warning once
    per target)."""
    global graph_captures
    C, D = b.vx.shape[0], b.slab_q.shape[2]
    query = b.vx[:, V_FIELDS.index("qt"), :D].contiguous()
    nbase = torch.zeros(1, dtype=torch.int32, device=b.vx.device)
    kernel_attributes(b.vx.dtype, "external", D)  # loads both entries
    try:
        graph = _capture(
            lambda: _queue_period(params, spec, query, nbase, launch),
            lambda: _gradient(spec.target, query))
        graph_captures += 1
    except CaptureError as e:
        graph = None
        if spec.target not in _warned:
            _warned.add(spec.target)
            warnings.warn(
                f"{spec.target.name}.logp_grad cannot be captured in a CUDA "
                f"graph ({e}); its periods run the same segments eagerly",
                RuntimeWarning)
    return _Period(graph, query, nbase, spec.target)


class CaptureError(RuntimeError):
    """A period's work could not be captured as a CUDA graph."""


def _capture(period, warm):
    """``period()`` (which queues work on the current stream) captured
    as a CUDA graph on a side stream, after three calls of ``warm()``
    there, so that autograd and the caching allocator set up outside
    the capture.  A failed capture raises :class:`CaptureError` (a
    launch error, and whatever ``warm`` raises, as they are), with the
    capture ended and the caller's stream current and ordered after the
    side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            for _ in range(3):
                warm()
            try:
                graph.capture_begin()
                try:
                    period()
                finally:
                    graph.capture_end()
            except RuntimeError as e:
                chain = [e]  # e, and the errors it was raised during
                while chain[-1].__context__ is not None:
                    chain.append(chain[-1].__context__)
                for x in chain:
                    if isinstance(x, LaunchError):
                        raise x
                raise CaptureError(str(chain[-1])) from e
    finally:
        torch.cuda.current_stream().wait_stream(side)
    return graph


def _gradient(target, q):
    """``target.logp_grad(q)`` as the segment kernel reads it: ``lp
    [C]`` and ``g [C, D]`` of ``q``'s dtype on ``q``'s device, raising
    on anything else (nothing is cast); a strided result is copied into
    a contiguous one.  An autograd target's gradient is taken whatever
    the caller's grad mode (``Target.logp_grad``)."""
    lp, g = target.logp_grad(q)
    C, D = q.shape
    for name, x, shape in (("log density", lp, (C,)),
                           ("gradient", g, (C, D))):
        if not isinstance(x, torch.Tensor) or x.dtype != q.dtype or \
                x.device != q.device or tuple(x.shape) != shape:
            got = (f"{tuple(x.shape)} {x.dtype} on {x.device}"
                   if isinstance(x, torch.Tensor) else type(x).__name__)
            raise TypeError(
                f"{target.name}.logp_grad: want the {name} as {shape} "
                f"{q.dtype} on {q.device}, got {got}")
    return lp.contiguous(), g.contiguous()


def kernel_attributes(dtype, target: str, D: int) -> dict:
    """What the kernel instantiation that runs ``dtype``, ``target`` (an
    ``INSTANTIATIONS`` key) and dimension ``D`` was built with, from the
    CUDA runtime on the current device: registers and local (stack)
    bytes per thread, shared bytes per block (static and dynamic),
    resident blocks and warps per SM, threads per block, warps per
    chain, and the trial-vector values per thread (``dpl``, 0 when they
    stay in the bank); for ``external`` also the micro-step segments'
    entry's registers and warps per SM.  Raises if the library's launch
    geometry is not :func:`launch_geometry`'s.  Querying an entry loads
    it, as a capture needs."""
    from .. import _build

    fn = _build.load().walnuts_round_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 9)()
    err = fn(0 if dtype == torch.float64 else 1, INSTANTIATIONS[target], D,
             out)
    if err != 0:
        raise RuntimeError(f"round kernel attributes: cudaError {err}")
    regs, local, shared, blocks, threads, dpl, m_regs, m_blocks, wpc = out
    want = launch_geometry(target, 1)[0], WARPS_PER_CHAIN[target]
    if (threads, wpc) != want:
        raise RuntimeError(
            f"round kernel {target}: the library launches {threads} threads "
            f"per block, {wpc} warps per chain; launch_geometry says "
            f"{want[0]}, {want[1]}")
    got = dict(regs=regs, local_bytes=local, shared_bytes=shared,
               blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
               threads_per_block=threads, warps_per_chain=wpc, dpl=dpl)
    if target == "external":
        got.update(micro_regs=m_regs,
                   micro_warps_per_sm=m_blocks * THREADS // 32)
    return got
