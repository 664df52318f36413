"""One flush period of the fused engine: sixteen rounds of every chain
and the ring flush, as a hand-written CUDA kernel and its plain twin.

Replaces the TPU kernel ``walnuts_tpu/sampler/pallas_megakernel.py``
(``_make_kernel``, launched by ``run_walnuts_pallas``).  That kernel
held a block of 128 chains in VMEM and ran the shared round body on
``[128, 128]`` tiles; on the v5e scoped VMEM capped the block there and
it lost to XLA.  The CUDA kernel (``csrc/round_kernel.cu``) instead
gives each chain one warp: the D coordinates spread over the lanes,
per-chain scalars sit in registers for the whole launch, the funnel
gradient is fused into the leapfrog step, and D-reductions (kinetic
energy, the funnel's sum of squares, U-turn and merge dots) are warp
shuffles.  Each warp follows its own chain's control flow, so no chain
waits on another's mask.

What bounds it on the H100: state bytes per round.  A round reads and
writes a chain's live trial vectors and, at a macro-step end, up to a
dozen more ``[D]`` vectors and the span slab: about 9.3 KB of vector
state plus 2.4 KB of bf16 slab per chain at D=101, m=8 in float32,
~100 MB for 8192 chains, twice the 50 MB L2.  The design keeps every
per-chain scalar in registers across the sixteen rounds of a launch
(so scalar state crosses device memory once per launch, not per
round), touches a vector only in the round and branch that needs it,
and stores the slab in bf16.  Keeping the vectors in registers or
shared memory is later work.

The state crosses the C interface as banks (the Pallas kernel's layout,
without its 128-lane padding): per-chain float scalars as rows of
``sf [NF, C]``, integers and flags as rows of ``si [NI, C]`` (int32),
the ``[C, D]`` vectors as planes of ``vx [NV, C, D]``, the slabs as
``[C, S, D]`` and the rings in the engine's ``[R, C, dg]`` /
``[Rd, C, 24]`` layout.  The P2 warmup estimators ride as extra rows.
"""

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..targets.analytic import omega_sumsq
from ..utils.p2 import P2State
from .driver import WarmupConfig
from .megakernel import (FLUSH_EVERY, STOP_MODES, MState, dtype_consts,
                         flush, make_hash_draw, make_round_body, protocol,
                         slab_dtype)
from .transition import WalnutsConfig

# ---------------------------------------------------------------------------
# bank layout (mirrored by the X-macro lists in csrc/round_kernel.cu)
# ---------------------------------------------------------------------------

F_FIELDS = (
    "h_loc", "lps", "h0s", "lpt", "ht", "dht", "fint", "lpa", "ha",
    "dha", "lpp", "hp", "lpm", "hm", "lpc", "lp_prop", "lp_prop_last",
    "mscale", "lwt_sum_f", "lwt_sum_b", "w_new_sum", "w_old_sum",
    "idx_time", "index_stat", "index_stat_old", "time_f", "time_b",
    "orbit_len", "orbit_len_sam", "h_min", "h_max", "lwt_min",
    "lwt_max", "h_cur", "delta_cur",
)
I_FIELDS = (
    "t", "it", "phase", "c_cur", "k", "i_f", "c_sim", "nev_f", "nev_b",
    "sel_l", "sel_l_old", "a_abs", "b_abs", "stop_code",
    "n_doubl_sampled", "n_doubl_computed", "max_f_int", "max_b_int",
    "neval_f", "neval_b", "if_min", "if_max", "c_min_d", "c_max_d",
    "n_states", "n_if_neq_ib", "n_if_zero", "grad_ct", "prow0",
    "prow1",
)
B_FIELDS = ("second", "coarse", "depth_done", "both_ends_passive",
            "pend0", "pend1")
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
    vx: torch.Tensor       # [NV, C, D] run dtype
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
    for p2 in (st.p2h, st.p2d):
        f_rows += list(p2.x.T) + list(p2.q.T) + [p2.p]
    for p2 in (st.p2h, st.p2d):
        i_rows += [p2.npush] + list(p2.n.T)
    return Banks(
        sf=torch.stack(f_rows),
        si=torch.stack(i_rows),
        vx=torch.stack([getattr(st, f) for f in V_FIELDS]),
        slab_q=st.slab_q.clone(memory_format=torch.contiguous_format),
        slab_v=st.slab_v.clone(memory_format=torch.contiguous_format),
        samples=st.samples.clone(memory_format=torch.contiguous_format),
        diags=st.diags.clone(memory_format=torch.contiguous_format),
    )


def unpack(b: Banks, n: int) -> MState:
    """Banks -> engine state at absolute round ``n``.  Float and integer
    fields are views into the banks (writing one writes the bank); the
    flags and ``xi_bits`` are converted copies."""
    dg = b.samples.shape[2]
    lay = layout(dg)
    d = {f: b.sf[i] for i, f in enumerate(F_FIELDS)}
    d.update({f: b.si[i] for i, f in enumerate(I_FIELDS)})
    d["xi_bits"] = b.si[I_XI].to(torch.int64) & 0xFFFFFFFF
    d.update({f: b.si[I_BOOL + j] != 0 for j, f in enumerate(B_FIELDS)})
    d.update({f: b.vx[i] for i, f in enumerate(V_FIELDS)})
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
    ``run_walnuts_fused`` and the int32 hash seed."""
    target: object
    cfg: WalnutsConfig
    warmup: Optional[WarmupConfig]
    stop_mode: str
    num_iter: int
    micro_unroll: int
    seed: int


launches = 0  # CUDA kernel launches made by run_rounds in this process


def run_rounds(b: Banks, n: int, spec: RoundSpec):
    """Advance every chain by one flush period (rounds ``n .. n+15``)
    and flush the rings, in place.  CUDA banks launch the kernel (or
    raise); CPU banks run the plain twin."""
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
    draw = make_hash_draw(spec.seed, torch.arange(C, device=st.qc.device),
                          D, st.qc.dtype)
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
         ("sf", "si", "vx", "slab_q", "slab_v", "samples", "diags")]
        + [(f, ctypes.c_double) for f in
           ("s_lo", "s_2sc", "p0", "lp_c", "lp_f", "thresh", "scale",
            "log_scale", "half_log2pi", "half_k", "half_k_log2pi",
            "scale_sq", "delta_target")]
        + [(f, ctypes.c_int) for f in
           ("C", "D", "S", "dg", "R", "Rd", "T_rows", "min_c", "max_c",
            "proto_d", "stop_mode", "num_iter", "micro_unroll", "nbase",
            "seed", "warmup", "adapt_h", "adapt_delta", "pooled",
            "warmup_iter", "target", "gen", "precision")])


KERNEL_TARGETS = {"funnel": 0, "std_gauss": 1}


def _gen_id(target):
    gen = target._generated
    if gen is None:
        return 0
    if gen is omega_sumsq:
        return 1
    raise NotImplementedError(
        f"the CUDA round kernel stores the identity or omega_sumsq "
        f"summary, not {gen!r}; other summaries wait for a kernel of "
        "their own (ROADMAP queue 2)")


def _params(b: Banks, n: int, spec: RoundSpec) -> _RoundParams:
    tgt, cfg, wu = spec.target, spec.cfg, spec.warmup
    if tgt.kernel_id not in KERNEL_TARGETS:
        raise NotImplementedError(
            f"the CUDA round kernel implements the funnel and std_gauss "
            f"targets, not {tgt.name!r}; other targets wait for the "
            "autograd path of ROADMAP queue 1 item 2 and a kernel of "
            "their own (ROADMAP queue 2)")
    NF, C = b.sf.shape
    D = b.vx.shape[2]
    S = b.slab_q.shape[1]
    dg = b.samples.shape[2]
    dtype = b.vx.dtype
    proto_d, min_c, max_c = protocol(cfg)
    lp_c, lp_f, thresh = dtype_consts(cfg, dtype)
    scale = tgt.kernel_param if tgt.kernel_id == "funnel" else 1.0
    log_2pi = math.log(2.0 * math.pi)
    k = D - 1
    s_sc = cfg.step_size_rand_scale
    return _RoundParams(
        *(t.data_ptr() for t in b),
        1.0 - s_sc, 2.0 * s_sc, cfg.igr.r2p_prob0, lp_c, lp_f, thresh,
        scale, math.log(scale), 0.5 * log_2pi, 0.5 * k, 0.5 * k * log_2pi,
        scale ** 2, wu.adapt_delta_target if wu else 0.0,
        C, D, S, dg, b.samples.shape[0], b.diags.shape[0],
        2 ** (cfg.m - 1), min_c, max_c, int(proto_d),
        STOP_MODES.index(spec.stop_mode), spec.num_iter, spec.micro_unroll,
        n, spec.seed, int(wu is not None), int(bool(wu and wu.adapt_h)),
        int(bool(wu and wu.adapt_delta)), int(bool(wu and wu.pooled)),
        wu.warmup_iter if wu else 0,
        KERNEL_TARGETS[tgt.kernel_id], _gen_id(tgt),
        0 if dtype == torch.float64 else 1)


def _check(b: Banks):
    dev = b.vx.device
    NV, C, D = b.vx.shape
    dtype = b.vx.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"round kernel runs float32 or float64, not {dtype}")
    dg = b.samples.shape[2]
    S = b.slab_q.shape[1]
    want = {
        "sf": ((layout(dg).nf, C), dtype),
        "si": ((NI, C), torch.int32),
        "vx": ((len(V_FIELDS), C, D), dtype),
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


def _launch(b: Banks, n: int, spec: RoundSpec):
    global launches
    from .. import _build

    _check(b)
    params = _params(b, n, spec)
    lib = _build.load()
    fn = lib.walnuts_round_launch
    fn.argtypes = [ctypes.POINTER(_RoundParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(b.vx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"round kernel launch failed: cudaError {err}")
    launches += 1
