"""The benchmark's yardstick on the CPU: the work-counted roofline, the
plain reference against the program's plain twin, and the reference's
independence from the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PORTBENCH = Path(__file__).resolve().parents[1]
REPO = PORTBENCH.parent
sys.path.insert(0, str(PORTBENCH))
sys.path.insert(0, str(REPO))

import roofline  # noqa: E402
from reference import consensus as ref_consensus  # noqa: E402
from reference import funnel, p2, stock_watson, walnuts  # noqa: E402


def test_roofline_counts_the_window_work_at_the_main_path_shape():
    # funnel(101) at 8192 chains in float32 (chip_smoke phase 5's shape):
    # 1e9 gradient evaluations and 2e6 draws of (omega, sum x^2)
    ops, nbytes = roofline.work(8192, 101, 4, 2, 10 ** 9, 2 * 10 ** 6, 12)
    assert ops == 10 ** 9 * 101 * 12
    assert nbytes == 2 * 8192 * (2 * 101 + 2) * 4 + 2 * 10 ** 6 * 2 * 4
    # bound by the operations: 1.212e12 / 67e12 s
    assert roofline.bound_s(ops, nbytes, "float32") == pytest.approx(
        1.212e12 / 67e12)
    # a window that drew but did no gradient work is bound by its bytes
    ops, nbytes = roofline.work(8192, 101, 4, 2, 0, 10 ** 9, 12)
    assert roofline.bound_s(ops, nbytes, "float32") == nbytes / 3.35e12


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    names = {n.split(".")[0] for p in (PORTBENCH / "reference").glob("*.py")
             for n in _imports(p)}
    assert not names & {"walnuts_tpu_torch", "walnuts_tpu", "jax",
                        "jaxlib", "flax"}
    code = ("import sys; sys.path.insert(0, '.');"
            "import reference.funnel, reference.stock_watson, "
            "reference.walnuts, reference.consensus, reference.p2;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'walnuts_tpu_torch', 'walnuts_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORTBENCH,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_reference_targets_equal_the_programs():
    import walnuts_tpu_torch as tw

    g = torch.Generator().manual_seed(5)
    q = 0.3 * torch.randn(4, 756, generator=g, dtype=torch.float64)
    ref = stock_watson.StockWatson(PORTBENCH / "data" / "swdata.json", True)
    prog = tw.targets.stock_watson(proper=True)
    for a, b in zip(ref.logp_grad(q), prog.logp_grad(q)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-9)
    np.testing.assert_allclose(ref.constrained(q).numpy(),
                               prog.generated(q).numpy(), rtol=1e-12)
    q = torch.randn(4, 101, generator=g, dtype=torch.float64)
    for a, b in zip(funnel.Funnel(101).logp_grad(q),
                    tw.targets.funnel(101).logp_grad(q)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("unroll", [1, 4])
def test_reference_engine_equals_the_programs_plain_twin(dtype, unroll):
    """The program on the CPU runs its plain twin; the reference, written
    apart from it, gives the same state after the same rounds."""
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch.sampler import megakernel

    C, D, m, rounds = 24, 11, 6, 320
    f = funnel.Funnel(D)
    q0 = f.exact(torch.Generator().manual_seed(9), C, dtype, "cpu")
    h, delta = torch.tensor(0.3), torch.tensor(0.25)
    st = megakernel.run_walnuts_fused(
        4321, q0, h, delta, target=tw.targets.funnel(
            D, generated=tw.targets.omega_sumsq),
        cfg=tw.WalnutsConfig(m=m), num_iter=50, stop_mode="min_per_chain",
        micro_unroll=unroll, rounds=rounds, device="cpu")[-1]
    slab = torch.bfloat16 if dtype == torch.float32 else dtype
    smp = walnuts.Sampler(dict(m=m, integrator="adapt_leapfrog_r2p"),
                          f.logp_grad, f.omega_sumsq, unroll, slab)
    s, draws = walnuts.run(smp, q0, h, delta, seed=4321,
                           cid=torch.arange(C), rounds=rounds, n_draws=3)
    for name in ("t", "k", "c_cur", "phase", "it", "grad_ct"):
        assert torch.equal(getattr(st, name).long(), s[name].long()), name
    for name in ("qt", "qc", "q_prop", "qp", "qm"):
        torch.testing.assert_close(getattr(st, name), s[name], rtol=1e-12,
                                   atol=1e-12)
    k = int(min(3, int(s["it"].min())))
    assert k > 0
    torch.testing.assert_close(st.samples[:k].transpose(0, 1),
                               draws[:, :k], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pooled", [True, False])
def test_reference_warmup_equals_the_programs_plain_twin(pooled):
    """In warmup the reference keeps its own estimators; pooled, it takes
    each period's (H, delta) from the program's consensus."""
    import walnuts_tpu_torch as tw
    from walnuts_tpu_torch.sampler import megakernel

    C, D, m, periods = 24, 11, 6, 16
    f = funnel.Funnel(D)
    g = torch.Generator().manual_seed(4)
    q0 = 0.3 * torch.randn(C, D, generator=g, dtype=torch.float64)
    h = delta = torch.tensor(0.3, dtype=torch.float64)
    kw = dict(target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=m),
              num_iter=10 ** 6, stop_mode="per_chain", ring_rows=8,
              warmup=tw.WarmupConfig(warmup_iter=10 ** 6, pooled=pooled),
              rounds=16, device="cpu")
    st, tuning = None, []
    for _ in range(periods):
        st = megakernel.run_walnuts_fused(777, q0, h, delta, mk_state=st,
                                          **kw)[-1]
        tuning.append((st.h_cur.clone(), st.delta_cur.clone()))
    smp = walnuts.Sampler(dict(m=m, integrator="adapt_leapfrog_r2p"),
                          f.logp_grad, f.identity, 1, torch.float64,
                          warmup=dict(warmup_iter=10 ** 6, pooled=pooled))
    s, _ = walnuts.run(smp, q0, h.expand(C), delta.expand(C), seed=777,
                       cid=torch.arange(C), rounds=16 * periods, n_draws=1,
                       tuning=tuning if pooled else ())
    assert int(s["p2h"]["npush"].min()) > 10
    assert int(s["p2d"]["npush"].max()) > 10
    assert len({float(x[0][0]) for x in tuning}) > 2
    for e in ("p2h", "p2d"):
        for name in ("npush", "n"):
            assert torch.equal(getattr(getattr(st, e), name).long(),
                               s[e][name].long()), (e, name)
        for name in ("q", "x"):
            torch.testing.assert_close(getattr(getattr(st, e), name),
                                       s[e][name], rtol=1e-12, atol=1e-12)
    for name in ("qc", "h_cur", "delta_cur"):
        torch.testing.assert_close(getattr(st, name), s[name], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reference_estimator_equals_the_programs(dtype):
    from walnuts_tpu_torch.utils.p2 import p2_init, p2_push

    C = 256
    g = torch.Generator().manual_seed(8)
    mine = p2.init(0.2, C, dtype, "cpu")
    theirs = p2_init(0.2, (C,), dtype)
    for i in range(60):
        x = torch.randn(C, generator=g, dtype=dtype) * (1 + i % 7)
        mask = torch.rand(C, generator=g) < 0.7
        mine = p2.push(mine, x, mask)
        theirs = p2_push(theirs, x, mask=mask)
    assert torch.equal(mine["npush"], theirs.npush)
    assert torch.equal(mine["n"], theirs.n)
    torch.testing.assert_close(mine["q"], theirs.q, rtol=0, atol=0)
    torch.testing.assert_close(mine["x"], theirs.x, rtol=0, atol=0)


def test_reference_consensus_equals_the_programs():
    from walnuts_tpu_torch.sampler import megakernel
    from walnuts_tpu_torch.sampler.driver import WarmupConfig
    from walnuts_tpu_torch.utils.p2 import p2_init, p2_push

    C = 64
    g = torch.Generator().manual_seed(3)
    p2h = p2_init(0.2, (C,), torch.float32)
    p2d = p2_init(0.9, (C,), torch.float32)
    for i in range(20):
        m = torch.rand(C, generator=g) < 0.8
        p2h = p2_push(p2h, torch.randn(C, generator=g), mask=m)
        p2d = p2_push(p2d, torch.rand(C, generator=g), mask=m)
    it = torch.randint(0, 50, (C,), generator=g, dtype=torch.int32)
    h0 = torch.full((C,), 0.3)

    class St:
        pass

    st = St()
    st.it, st.p2h, st.p2d, st.h_cur, st.delta_cur = it, p2h, p2d, h0, h0
    wu = WarmupConfig(warmup_iter=700, pooled=True)
    h, d = megakernel.pooled_consensus(st, wu)
    nan = torch.tensor(float("nan"))
    rh, rd = ref_consensus.consensus(it, p2h.npush, p2h.q[:, 2], p2d.npush,
                                     p2d.q[:, 2], 700, 0.6, nan, nan)
    torch.testing.assert_close(h, rh.expand(C), rtol=1e-6, atol=0)
    torch.testing.assert_close(d, rd.expand(C), rtol=1e-6, atol=0)


def test_the_stock_watson_mode_file_is_the_reference_mode():
    d = json.loads((PORTBENCH / "data" / "stockwatson_mode.json").read_text())
    ref = stock_watson.StockWatson(PORTBENCH / "data" / "swdata.json", True)
    q = torch.tensor(d["q"], dtype=torch.float32)
    assert q.shape == (756,)
    assert float(ref.logp_grad(q[None])[0][0]) == pytest.approx(d["logp"],
                                                                 abs=1e-3)
