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
    banks = rk.pack(_state())
    spec = rk.RoundSpec(target=tw.targets.funnel(D),
                        cfg=tw.WalnutsConfig(m=M), warmup=None,
                        stop_mode="per_chain", num_iter=10, micro_unroll=1,
                        seed=1)
    params = rk._params(banks, 0, spec)
    assert (params.C, params.D, params.S, params.target, params.gen) == (
        C, D, M - 2, 0, 0)
    assert params.precision == 0 and params.T_rows == 2 ** (M - 1)
    custom = tw.Target(tw.targets.funnel(D)._logp, D)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rk._params(banks, 0, spec._replace(target=custom))
    odd_summary = tw.targets.funnel(D, generated=lambda q: q[..., :1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rk._params(banks, 0, spec._replace(target=odd_summary))
    rk._check(banks)
    with pytest.raises(ValueError, match="si"):
        rk._check(banks._replace(si=banks.si.long()))
    with pytest.raises(ValueError, match="contiguous"):
        rk._check(banks._replace(vx=banks.vx.transpose(1, 2).contiguous()
                                 .transpose(1, 2)))


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
