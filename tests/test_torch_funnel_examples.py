"""The port's funnel harnesses (``walnuts_tpu_torch.examples.funnel`` and
``funnel_transient``) against the JAX harnesses ``examples/funnel.py``
and ``examples/funnel_transient.py``, imported by path, on the CPU.

``funnel``: the start draws the JAX harness's normals (bit for bit on
most entries, within a few ulp on the rest: XLA's CPU ``log1p``); in
float64 at D = 5 and 8 chains, the matched-work NUTS run (no warmup)
equals the JAX harness's call (``:99-101``) under ``EXACT`` and the
WALNUTS run with its per-chain warmup (``:55-58``) over 20 iterations
under ``ADAPTIVE``; the record and the three gates equal those the JAX
harness's ``main`` computes (``:59-143``) from the same arrays.
``funnel_transient``: the scan arm's first two chunks (chunk = 1,
max_c = 8, float64) equal the JAX calls at ``:137`` under ``EXACT``,
chunk by chunk and in the written record; the native arm's first
chunks equal the JAX harness's ``native_main`` bit for bit."""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
from walnuts_tpu_torch.examples import funnel as fx
from walnuts_tpu_torch.examples import funnel_transient as ftx
from walnuts_tpu_torch.utils.parity import (ADAPTIVE, ENERGY_RANGE,
                                            ENERGY_RANGE_COL, EXACT,
                                            assert_parity)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfx = _load("funnel")
jftx = _load("funnel_transient")

D, C, M = 5, 8, 10
WARMUP, ITERS = 10, 20


def _np(x):
    return x.cpu().numpy()


def test_funnel_seeds_and_start_are_the_jax_harness():
    assert (fx.SEED_WALNUTS, fx.SEED_NUTS) == (1, 2)
    want = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(0),
                                              (256, 11), jnp.float32))
    got = fx.start(256, 11).numpy()
    assert got.dtype == np.float32
    assert np.mean(got == want) >= 0.98
    ulp = np.spacing(np.maximum(np.abs(want), 0.1).astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * ulp)


@pytest.fixture(scope="module")
def runs():
    """The port's two runs and the JAX harness's calls, float64."""
    q0 = fx.start(C, D, torch.float64)
    jq0 = jnp.asarray(q0.numpy())
    walnuts = fx.run_walnuts_arm(q0, m=M, warmup=WARMUP, iters=ITERS,
                                 device="cpu")
    h = fx.matched_h(walnuts[1], WARMUP)
    nuts = fx.run_nuts_arm(q0, h, m=M, iters=ITERS, device="cpu")
    jw = wt.run_walnuts(
        jax.random.PRNGKey(1), jq0, target=wt.targets.funnel(D),
        cfg=wt.WalnutsConfig(m=M, record_orbit_stats=True),
        warmup=wt.WarmupConfig(warmup_iter=WARMUP), num_iter=ITERS, h0=0.3,
        delta0=0.3, collect_orbit_stats=True)
    jn = wt.run_walnuts(
        jax.random.PRNGKey(2), jq0, target=wt.targets.funnel(D),
        cfg=wt.WalnutsConfig(m=M, integrator="fixed_leapfrog"),
        warmup=wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                               adapt_delta=False),
        num_iter=ITERS, h0=h, delta0=0.3)
    return walnuts, nuts, h, jw, jn


def test_funnel_nuts_run_equals_the_jax_harness_call(runs):
    _, (st, dt, seconds), _, _, (sj, dj, _) = runs
    assert_parity(np.asarray(sj), _np(st), EXACT, "samples")
    assert_parity(np.asarray(dj), _np(dt), EXACT, "diagnostics")
    assert seconds > 0


def test_funnel_walnuts_warmup_run_follows_the_jax_harness_call(runs):
    (st, dt, state, ot, xt, _), _, _, (sj, dj, sstj, oj, xj), _ = runs
    assert_parity(np.asarray(sj), _np(st), ADAPTIVE, "samples")
    dj, dt = np.asarray(dj), _np(dt)
    cols = [c for c in range(24) if c != ENERGY_RANGE_COL]
    assert_parity(dj[..., cols], dt[..., cols], ADAPTIVE, "diagnostics")
    assert_parity(dj[..., ENERGY_RANGE_COL], dt[..., ENERGY_RANGE_COL],
                  ENERGY_RANGE, "energy range")
    for name, a, b in (("omin", oj, ot), ("omax", xj, xt),
                       ("h", sstj.h, state.h), ("delta", sstj.delta,
                                                state.delta)):
        assert_parity(np.asarray(a), _np(b), ADAPTIVE, name)


def _close(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) <= set(got), path
        for k in want:
            _close(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, bool):
        assert got is want, path
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **EXACT)


def test_funnel_record_and_gates_are_the_jax_harness_arithmetic(
        runs, tmp_path, monkeypatch):
    """JAX's ``main`` over the port's arrays (its engine calls patched to
    return them, WALNUTS then NUTS) against :func:`funnel.report`."""
    walnuts, nuts, h, _, _ = runs
    calls = []

    def fake(*args, h0, **kw):
        calls.append(h0)
        if len(calls) == 1:
            st, dt, state, ot, xt, _ = walnuts
            return (jnp.asarray(_np(st)), jnp.asarray(_np(dt)),
                    wt.sampler.driver.SamplerState(
                        *([None] * 3), jnp.asarray(_np(state.h)),
                        jnp.asarray(_np(state.delta)), *([None] * 3)),
                    jnp.asarray(_np(ot)), jnp.asarray(_np(xt)))
        return (jnp.asarray(_np(nuts[0])), jnp.asarray(_np(nuts[1])), None)

    monkeypatch.setattr(wt, "run_walnuts", fake)
    monkeypatch.setattr(sys, "argv", [
        "prog", "--dim", str(D), "--chains", str(C), "--iters", str(ITERS),
        "--warmup", str(WARMUP), "--m", str(M),
        "--out", str(tmp_path / "j.json")])
    try:
        jfx.main()
    except SystemExit:
        pass
    want = json.loads((tmp_path / "j.json").read_text())
    assert calls == [0.3, pytest.approx(h, rel=1e-15)]
    got = fx.report(D, WARMUP, walnuts[:5], nuts[:2], h, device="cpu")
    got = json.loads(json.dumps(got, default=float))
    _close(want, got)
    assert got["acceptance"] == fx.acceptance(got["walnuts"])


def test_funnel_gates_fail_past_their_tolerances():
    w = {"tail_fraction_exact": 0.15865525393145707, "ess_omega": 400.0,
         "tail_fraction": 0.16, "tail_qq_rmse_below_-3": 0.1, "omega_sd": 3.0}
    assert fx.acceptance(w)["pass"]
    for k, bad in (("tail_fraction", 0.3), ("tail_qq_rmse_below_-3", 5.0),
                   ("omega_sd", 4.0)):
        assert not fx.acceptance(dict(w, **{k: bad}))["pass"]


MAX_C = 8


def test_transient_scan_chunks_equal_the_jax_harness_calls(tmp_path,
                                                           monkeypatch):
    """Two chunks of one iteration (``funnel_transient.py:132-149``), then
    the record both harnesses write after them."""
    cfg = wt.WalnutsConfig(m=12, record_orbit_stats=True,
                           igr=wt.IntegratorConfig(min_c=0, max_c=MAX_C))
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    q0 = jnp.zeros((2, 11), jnp.float64).at[:, 0].set(-30.0)
    state, outs = None, []
    chunks = ftx.run_scan_chunks(chains=2, iters=2, chunk=1, max_c=MAX_C,
                                 dtype=torch.float64, device="cpu")
    for done, st, dt, _, ot, xt in chunks:
        key = jax.random.fold_in(jax.random.PRNGKey(1), done - 1)
        np.testing.assert_array_equal(
            ftx.scan_chunk_key(done - 1).numpy().astype(np.uint32),
            np.asarray(key))
        sj, dj, state, oj, xj = wt.run_walnuts(
            key, q0, target=wt.targets.funnel(11), cfg=cfg, warmup=wu,
            num_iter=1, h0=0.3, delta0=0.3, collect_orbit_stats=True,
            resume_state=state)
        outs.append((sj, dj, state, oj, xj))
        for name, a, b in (("samples", sj, st), ("diagnostics", dj, dt),
                           ("omin", oj, ot), ("omax", xj, xt)):
            assert_parity(np.asarray(a), _np(b), EXACT, f"{done} {name}")
    # the JAX harness's main over the calls' outputs (replayed, so as not
    # to compile them again)
    monkeypatch.setattr(wt, "run_walnuts", lambda *a, **k: outs.pop(0))
    argv = ["--chains", "2", "--iters", "2", "--chunk", "1", "--max-c",
            str(MAX_C), "--dtype", "float64"]
    monkeypatch.setattr(sys, "argv", ["prog"] + argv + [
        "--out", str(tmp_path / "j.json")])
    jftx.main()
    assert not outs
    ftx.main(argv + ["--engine", "xla", "--device", "cpu",
                     "--out", str(tmp_path / "p.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    assert set(want) <= set(got)
    for k, v in want.items():
        if isinstance(v, (list, float)):
            assert_parity(v, got[k], EXACT, k)
        else:
            assert got[k] == v, k
    assert got["s_per_transition"] == got["seconds"] / 2 and got["card"]


def test_transient_native_chunks_equal_the_jax_harness_bit_for_bit(tmp_path):
    args = argparse.Namespace(iters=16, chunk=8, max_c=10, seed=1,
                              out=str(tmp_path / "j.json"))
    jftx.native_main(args)
    want = json.loads((tmp_path / "j.json").read_text())
    got = ftx.run_native(seed=1, iters=16, chunk=8, max_c=10,
                         out=tmp_path / "p.json", log=lambda s: None)
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(
        json.dumps(got))
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert ftx.native_chunk_seed(2, 50) == 2 * 100003 + 50
    assert got["grad_evals_total"] == sum(got["grad_evals_per_iter"])
