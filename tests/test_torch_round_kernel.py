"""The round kernel's wrapper: bank layout, the C interface it mirrors,
dispatch, and its plain twin against the JAX engine.  The CUDA kernel
itself is held against the plain twin in
``test_torch_round_kernel_gpu.py`` on a GPU host."""

import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.sampler.megakernel import run_walnuts_fused as jax_fused
from walnuts_tpu_torch import _build
from walnuts_tpu_torch.sampler import megakernel as mk
from walnuts_tpu_torch.sampler import round_kernel as rk

torch.set_num_threads(2)

SRC = (Path(__file__).resolve().parents[1] / "walnuts_tpu_torch" / "csrc"
       / "round_kernel.cu").read_text()
C, D, M = 12, 5, 4
KEY = jax.random.PRNGKey(8)
SEED = int(jax.random.randint(jax.random.fold_in(KEY, 777), (1,), 0,
                              2 ** 30, jnp.int32)[0])
Q0 = 0.4 * np.random.default_rng(3).normal(size=(C, D))
RUN = dict(num_iter=30, stop_mode="per_chain", diag_rows=4)


def _xmacro(name):
    """Field names of an X-macro list, with nested lists expanded."""
    body = re.search(rf"#define {name}\(X\)(.*?)\n\n", SRC, re.S).group(1)
    names = []
    for sub, field in re.findall(r"(\w+_LIST)\(X\)|X\((\w+)\)", body):
        names += _xmacro(sub) if sub else [field]
    return tuple(names)


def test_bank_layout_mirrors_cuda_source():
    assert _xmacro("F_LIST") == rk.F_FIELDS
    assert _xmacro("I_LIST") == rk.I_FIELDS
    assert _xmacro("F_HOT_LIST") == rk.F_HOT == rk.F_FIELDS[:len(rk.F_HOT)]
    assert _xmacro("I_HOT_LIST") == rk.I_HOT == rk.I_FIELDS[:len(rk.I_HOT)]
    assert _xmacro("B_HOT_LIST") == rk.B_HOT == rk.B_FIELDS[:len(rk.B_HOT)]
    assert _xmacro("B_LIST") == rk.B_FIELDS
    assert _xmacro("V_LIST") == rk.V_FIELDS
    fields = set(rk.F_FIELDS + rk.I_FIELDS + rk.B_FIELDS + rk.V_FIELDS)
    rest = {"n", "xi_bits", "slab_q", "slab_v", "samples", "diags", "pgen0",
            "pgen1", "pdiag0", "pdiag1", "p2h", "p2d"}
    assert fields | rest == set(mk.MState._fields)
    assert not fields & rest


def test_params_struct_mirrors_cuda_source():
    body = re.search(r"struct RoundParams \{(.*?)\};", SRC, re.S).group(1)
    names, kinds = [], []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind, rest = decl.split(None, 1)
        for name in rest.split(","):
            names.append(name.strip().lstrip("*"))
            kinds.append("ptr" if "*" in name else kind)
    want = {"ptr": "c_void_p", "double": "c_double", "int": "c_int"}
    got = [(f, t.__name__) for f, t in rk._RoundParams._fields_]
    assert got == [(n, want[k]) for n, k in zip(names, kinds)]


def _state():
    return mk.init_state(torch.from_numpy(Q0), 0.4, 0.15,
                         target=tw.targets.funnel(D),
                         cfg=tw.WalnutsConfig(m=M),
                         warmup=tw.WarmupConfig(), num_iter=10)


def test_pack_unpack_round_trip():
    st = _state()._replace(xi_bits=torch.tensor(
        [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1] + [7] * (C - 5)))
    back = rk.unpack(rk.pack(st), 5)
    assert back.n == 5
    for name in mk.MState._fields[1:]:
        a, b = getattr(st, name), getattr(back, name)
        for x, y in (zip(a, b) if name in ("p2h", "p2d") else [(a, b)]):
            assert x.dtype == y.dtype, name
            torch.testing.assert_close(y, x, rtol=0, atol=0)
    banks = rk.pack(st)
    assert banks.si.shape == (rk.NI, C) and banks.si.dtype == torch.int32
    assert banks.sf.shape == (rk.layout(D).nf, C)
    assert banks.vx.shape == (C, len(rk.V_FIELDS), rk.padded(D))


@pytest.mark.parametrize("dim,dp", [(5, 32), (32, 32), (33, 64), (101, 128),
                                    (200, 224)])
def test_vector_bank_is_chain_major_and_zero_padded(dim, dp):
    """One chain's vectors are one block of ``NV`` rows of ``Dp`` values,
    zero past D; every vector field of the state is a view of its
    column in the bank and comes back bit for bit."""
    rng = np.random.default_rng(dim)
    st = mk.init_state(torch.from_numpy(rng.normal(size=(3, dim))), 0.4, 0.2,
                       target=tw.targets.funnel(dim),
                       cfg=tw.WalnutsConfig(m=M), warmup=None, num_iter=4)
    st = st._replace(**{f: torch.from_numpy(rng.normal(size=(3, dim)))
                        for f in rk.V_FIELDS})
    banks = rk.pack(st)
    assert rk.padded(dim) == dp
    assert banks.vx.shape == (3, len(rk.V_FIELDS), dp)
    assert banks.vx.is_contiguous()
    assert not banks.vx[:, :, dim:].any()
    back = rk.unpack(banks, 0)
    for i, f in enumerate(rk.V_FIELDS):
        torch.testing.assert_close(getattr(back, f), getattr(st, f),
                                   rtol=0, atol=0)
        assert getattr(back, f).data_ptr() == banks.vx[0, i].data_ptr()
    rk._check(banks)
    if dim < dp:
        with pytest.raises(ValueError, match="vx"):
            rk._check(banks._replace(vx=banks.vx[:, :, :dim].contiguous()))


@pytest.fixture(scope="module")
def jax_states():
    """JAX engine states after 80 and 96 rounds: one flush period apart."""
    def run(rounds):
        return jax_fused(
            KEY, jnp.asarray(Q0), jnp.full((C,), 0.4), jnp.full((C,), 0.15),
            target=wt.targets.funnel(D), cfg=wt.WalnutsConfig(m=M),
            rounds=rounds, rng="hash", **RUN)[-1]
    return run(80), run(96)


def _numpy(st):
    return {f: (jax.tree.map(np.asarray, v) if f in ("p2h", "p2d")
                else np.asarray(v)) for f, v in st._asdict().items()}


def test_one_flush_period_on_cpu_matches_jax(jax_states):
    """``run_rounds`` on CPU banks is the plain twin: one call advances
    JAX's state by 16 rounds exactly as the JAX engine does, and makes
    no kernel launch."""
    st80, st96 = jax_states
    banks = rk.pack(mk.mstate_from_numpy(_numpy(st80)))
    spec = rk.RoundSpec(target=tw.targets.funnel(D),
                        cfg=tw.WalnutsConfig(m=M), warmup=None,
                        stop_mode=RUN["stop_mode"], num_iter=RUN["num_iter"],
                        micro_unroll=1, seed=SEED)
    launches = rk.launches
    rk.run_rounds(banks, 80, spec)
    assert rk.launches == launches
    want = rk.pack(mk.mstate_from_numpy(_numpy(st96)))
    torch.testing.assert_close(banks.si, want.si, rtol=0, atol=0)
    for name in ("sf", "vx", "slab_q", "slab_v", "samples", "diags"):
        torch.testing.assert_close(getattr(banks, name), getattr(want, name),
                                   rtol=1e-9, atol=1e-12)
    assert int(banks.si[rk.I_FIELDS.index("it")].sum()) > 0


def test_kernel_dispatch_rejects_what_it_does_not_implement():
    """A target without a fused gradient gets the external-gradient
    instantiation; a summary the kernel does not store, and banks of the
    wrong dtype or layout, raise."""
    banks = rk.pack(_state())
    spec = rk.RoundSpec(target=tw.targets.funnel(D),
                        cfg=tw.WalnutsConfig(m=M), warmup=None,
                        stop_mode="per_chain", num_iter=10, micro_unroll=1,
                        seed=1)
    params = rk._params(banks, 0, spec)
    assert (params.C, params.D, params.S, params.target, params.gen) == (
        C, D, M - 2, 0, 0)
    assert params.precision == 0 and params.T_rows == 2 ** (M - 1)
    assert params.seg == 0 and not (params.xq or params.xlp or params.xg)
    custom = tw.Target(tw.targets.funnel(D)._logp, D)
    params = rk._params(banks, 0, spec._replace(target=custom))
    assert (params.target, params.gen, params.sw_T) == (rk.EXTERNAL, 0, 0)
    odd_summary = tw.targets.funnel(D, generated=lambda q: q[..., :1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rk._params(banks, 0, spec._replace(target=odd_summary))
    rk._check(banks)
    with pytest.raises(ValueError, match="si"):
        rk._check(banks._replace(si=banks.si.long()))
    with pytest.raises(ValueError, match="contiguous"):
        rk._check(banks._replace(vx=banks.vx.transpose(1, 2).contiguous()
                                 .transpose(1, 2)))


def _lambda_summary(q):
    """``bench.py``'s (omega, sum x^2) summary written as a new
    function: the kernel matches ``omega_sumsq`` by identity only."""
    return torch.stack([q[..., 0], torch.sum(q[..., 1:] ** 2, dim=-1)], -1)


def test_check_card_decides_the_route_from_the_spec():
    spec = rk.RoundSpec(target=tw.targets.funnel(D),
                        cfg=tw.WalnutsConfig(m=M), warmup=None,
                        stop_mode="per_chain", num_iter=10, micro_unroll=1,
                        seed=1)
    for target in (tw.targets.funnel(D), tw.targets.std_gauss(D),
                   tw.targets.funnel(D, generated=tw.targets.omega_sumsq),
                   tw.targets.stock_watson()):
        assert rk.check_card(spec._replace(target=target))
    assert not rk.check_card(spec._replace(
        target=tw.targets.funnel(D, generated=_lambda_summary)))
    # every target runs on the card: without a fused gradient (and for a
    # Stock-Watson series past SW_TMAX) through the external-gradient
    # instantiation, which stores the identity and omega_sumsq itself
    long_sw = tw.targets.stock_watson()
    long_sw.kernel_args["T"] = rk.SW_TMAX + 1
    banks = rk.pack(_state())
    for target in (tw.targets.smile(),
                   tw.Target(tw.targets.funnel(D)._logp, D),
                   tw.Target(tw.targets.funnel(D)._logp, D,
                             generated=tw.targets.omega_sumsq),
                   long_sw):
        assert rk._target_id(target, target.dim) == rk.EXTERNAL
        assert rk.check_card(spec._replace(target=target)) == (
            target is not long_sw)  # its summary is mapped in torch
    assert rk._params(banks, 0, spec._replace(
        target=tw.targets.smile())).target == rk.EXTERNAL
    assert rk._target_id(tw.targets.stock_watson(), 756) == 2
    assert rk._target_id(long_sw, 756) == rk.EXTERNAL


def _counted_target(calls):
    """funnel(D) as a user target (no ``kernel_id``) whose ``logp_grad``
    records each query it is handed."""
    base = tw.targets.funnel(D)

    def logp_grad(q):
        calls.append(q.data_ptr())
        return base.logp_grad(q)

    return tw.Target(base._logp, D, logp_grad=logp_grad)


@pytest.mark.parametrize("micro_unroll", [1, 4])
def test_segment_schedule_calls_the_gradient_between_launches(micro_unroll):
    """The external route's host loop for one period: ``16 *
    micro_unroll + 1`` segment launches, one gradient call on the query
    tensor between each two, and each launch after the first handed the
    result of the call before it (the launch itself is recorded here:
    the kernel runs on the card)."""
    calls, seen = [], []
    target = _counted_target(calls)
    banks = rk.pack(_state())
    spec = rk.RoundSpec(target=target, cfg=tw.WalnutsConfig(m=M),
                        warmup=None, stop_mode="per_chain", num_iter=10,
                        micro_unroll=micro_unroll, seed=1)
    params = rk._params(banks, 0, spec)
    assert params.target == rk.EXTERNAL

    def launch():
        seen.append((params.seg, params.xq, params.xlp, params.xg))

    before = rk.segment_launches
    rk._run_segments(banks, params, spec, launch)
    last = 16 * micro_unroll
    assert rk.segment_launches - before == last + 1
    assert [s[0] for s in seen] == list(range(last + 1))
    assert len(calls) == last and set(calls) == {seen[0][1]}
    assert all(s[1] == seen[0][1] for s in seen)  # one query tensor
    assert seen[0][2:] == (None, None)
    assert all(s[2] and s[3] for s in seen[1:])


def test_gradient_exchange_checks_what_torch_returns():
    """What the segment kernel reads from torch: ``lp [C]`` and ``g [C,
    D]`` in the query's dtype on its device; anything else raises, a
    strided result is copied into a contiguous one."""
    q = torch.from_numpy(Q0)
    good = tw.targets.funnel(D)
    lp, g = rk._gradient(good, q)
    want = good.logp_grad(q)
    assert torch.equal(lp, want[0]) and torch.equal(g, want[1])
    strided = tw.Target(good._logp, D, logp_grad=lambda x: (
        good.logp_grad(x)[0], good.logp_grad(x)[1].T.contiguous().T))
    lp2, g2 = rk._gradient(strided, q)
    assert g2.is_contiguous() and torch.equal(g2, want[1])
    for name, fn in (
            ("dtype", lambda x: (lp, g.float())),
            ("shape", lambda x: (lp[:, None], g)),
            ("shape", lambda x: (lp, g[:, :-1])),
            ("type", lambda x: (lp.numpy(), g))):
        bad = tw.Target(good._logp, D, logp_grad=fn, name=name)
        with pytest.raises(TypeError, match=f"{name}.logp_grad"):
            rk._gradient(bad, q)
    # an autograd target under no_grad still gets its gradient
    with torch.no_grad():
        lp3, g3 = rk._gradient(tw.Target(good._logp, D), q)
    torch.testing.assert_close(g3, want[1], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lp3, want[0], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("stop_mode,ring_rows", [
    ("per_chain", None), ("total", 3), ("total", 1), ("min_per_chain", None)])
def test_deferred_summary_writes_the_rows_the_flush_would(stop_mode,
                                                         ring_rows):
    """The kernel's side of a summary it does not store, with the plain
    twin standing in for the kernel: positions staged in two-row rings
    and mapped after each period equal the plain run that stores the
    summary itself (rings that wrap under ``total`` included)."""
    target = tw.targets.funnel(D, generated=_lambda_summary)
    kw = dict(target=target, cfg=tw.WalnutsConfig(m=M), num_iter=6,
              stop_mode=stop_mode, ring_rows=ring_rows, diag_rows=4,
              micro_unroll=2)
    want = mk.run_walnuts_fused(SEED, Q0, 0.4, 0.15, device="cpu", **kw)
    spec = rk.RoundSpec(target=target, cfg=kw["cfg"], warmup=None,
                        stop_mode=stop_mode, num_iter=6, micro_unroll=2,
                        seed=SEED)
    st = mk.init_state(torch.from_numpy(Q0), 0.4, 0.15, target=target,
                       cfg=kw["cfg"], warmup=None, num_iter=6,
                       ring_rows=ring_rows, diag_rows=4)
    ring = st.samples.clone()
    ident, st = rk.defer_summary(st, target)
    assert not rk.check_card(spec) and rk.check_card(
        spec._replace(target=ident))
    banks = rk.pack(st)
    view = rk.unpack(banks, 0)
    n = 0
    while (int(view.it.sum()) < C * 6 if stop_mode == "total"
           else bool((view.it < 6).any())):
        it0 = view.it.clone()
        rk.run_rounds_plain(banks, n, spec._replace(target=ident))
        rk.summarize(ring, view.samples, it0, view.it, target, stop_mode, 6)
        n += 16
    assert torch.equal(view.it, want[3])
    assert int(want[3].sum()) > 0
    torch.testing.assert_close(ring, want[0], rtol=0, atol=0)
    torch.testing.assert_close(banks.diags, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("values", [
    [3.0, 1.0, float("nan"), 2.0],
    [4.0, float("nan"), 1.0, 2.0, 3.0],
    [float("nan")] * 3,
    [5.0],
])
def test_nanmedian_is_numpys(values):
    got = float(mk._nanmedian(torch.tensor(values, dtype=torch.float64)))
    want = float(np.nanmedian(values)) if not np.isnan(values).all() \
        else float("nan")
    np.testing.assert_equal(got, want)


def test_pooled_consensus_makes_no_host_sync():
    """The consensus runs between kernel launches; an ``item()`` inside
    it would make the host wait for the kernel before queueing more."""
    from torch.profiler import ProfilerActivity, profile

    st = _state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mk.pooled_consensus(st, tw.WarmupConfig(pooled=True))
    ops = {e.key for e in prof.key_averages()}
    assert "aten::sort" in ops
    assert "aten::_local_scalar_dense" not in ops


def test_build_raises_without_nvcc():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc present: the build is exercised by the cuda cases")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert _build.library_path().parent == _build.BUILD
