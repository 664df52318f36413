"""The port's gaussian-ESS harness (``walnuts_tpu_torch.examples.
gaussian_ess``) against the JAX harness ``examples/gaussian_ess.py``,
imported by path, on the CPU.

The chunked engine loop at d = 16, float64, equals the JAX harness's
loop (its ``wt.run_walnuts`` calls at ``:91-100``, with the same keys
and resumed state) under ``EXACT`` for every integrator, across a chunk
boundary; the record equals the JAX ``run_one``'s on the same arrays
(its engine call patched to return them); given the same fragment
records, the port's ``main`` pools the replicas, fits the slope and
exits as the JAX ``main`` does.  The start is the JAX harness's normal
within threefry's few-ulp contract; the harness raises without a card
unless asked for the CPU."""

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
from walnuts_tpu_torch.examples import gaussian_ess as ge
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jge = _load("gaussian_ess")


def private_fragments(mod, prefix, tmp_path, monkeypatch):
    """Make the JAX harness ``mod``'s ``main`` keep its fragments in
    ``tmp_path``: the names under ``prefix`` (its fixed ``/tmp`` names)
    map there, and a missing fragment fails instead of starting the
    harness in a subprocess.  Returns the name map."""
    def local(name):
        name = str(name)
        return (str(tmp_path / name[len("/tmp/"):])
                if name.startswith(prefix) else name)

    def no_subprocess(cmd, *a, **kw):
        raise AssertionError(f"a fragment is missing: {cmd}")

    real_open = open
    monkeypatch.setattr(mod, "open", lambda name, *a, **kw: real_open(
        local(name), *a, **kw), raising=False)
    monkeypatch.setattr(mod, "os", SimpleNamespace(
        path=SimpleNamespace(exists=lambda name: os.path.exists(local(name)),
                             abspath=os.path.abspath),
        replace=os.replace))
    monkeypatch.setattr(mod, "subprocess", SimpleNamespace(run=no_subprocess))
    return local

LOG2D, C, ITERS, CHUNK, REP = 4, 8, 6, 3, 1
# diagnostics columns that hold integers (scan engine, 24 columns)
INT_COLS = [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22]


def _jax_target(d):
    """The JAX harness's target (``gaussian_ess.py:67-73``)."""
    base = wt.targets.std_gauss(d)
    return wt.targets.Target(
        logp=base._logp, dim=d, name=f"std_gauss{d}",
        generated=lambda q: jnp.stack(
            [q[..., 0], jnp.sum(q * q, axis=-1)], axis=-1),
        logp_grad=base.logp_grad)


def _jax_loop(log2d, integ, q0, iters, chunk, rep):
    """``gaussian_ess.py:76-100`` at a chunk of ``chunk`` transitions."""
    d = 2 ** log2d
    cfg = wt.WalnutsConfig(m=10, integrator=integ)
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    t = _jax_target(d)
    state = None
    s_parts, d_parts = [], []
    done = 0
    while done < iters:
        n = min(chunk, iters - done)
        samples, diags, state = wt.run_walnuts(
            jax.random.fold_in(
                jax.random.PRNGKey(100 + 1000 * rep + log2d), done),
            q0, target=t, cfg=cfg, warmup=wu, num_iter=n,
            h0=1.4 * d ** -0.25, delta0=0.3, resume_state=state)
        s_parts.append(np.asarray(samples, np.float64)[1:])
        d_parts.append(np.asarray(diags))
        done += n
    return np.concatenate(s_parts), np.concatenate(d_parts)


@pytest.fixture(scope="module")
def runs():
    """Both loops for every integrator from one float64 start."""
    q0 = ge.start(LOG2D, C, REP, torch.float64)
    out = {}
    for integ, tag in ge.INTEGRATORS:
        want = _jax_loop(LOG2D, integ, jnp.asarray(q0.numpy()), ITERS, CHUNK,
                         REP)
        got = ge.sample(LOG2D, integ, q0, ITERS, REP, chunk=CHUNK,
                        device="cpu")
        out[tag] = (want, got)
    return out


def test_constants_are_the_jax_harness():
    assert ge.INTEGRATORS == jge.INTEGRATORS
    for d in [2 ** k for k in range(4, 19)]:
        for chains in (8, 16, 64, 100):
            assert ge.chains_for(d, chains) == jge.chains_for(d, chains)
    assert ge.default_chunk(2 ** 18) == 25 and ge.default_chunk(256) == 100
    key = ge.chunk_key(LOG2D, REP, 75)
    want = jax.random.fold_in(jax.random.PRNGKey(100 + 1000 * REP + LOG2D),
                              75)
    np.testing.assert_array_equal(key.numpy().astype(np.uint32),
                                  np.asarray(want))


def test_start_is_the_jax_harness_draw():
    """``normal(PRNGKey(1000 rep + log2d))`` in float32: within threefry's
    few-ulp contract (XLA's CPU ``log1p`` differs from torch's), bit for
    bit on most entries."""
    for log2d, rep in ((4, 0), (8, 2)):
        want = np.asarray(jax.random.normal(
            jax.random.PRNGKey(1000 * rep + log2d), (C, 2 ** log2d),
            jnp.float32))
        got = ge.start(log2d, C, rep).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))
        assert np.mean(got == want) > 0.8


@pytest.mark.parametrize("tag", [t for _, t in ge.INTEGRATORS])
def test_chunked_loop_equals_the_jax_harness(runs, tag):
    (sj, dj), (st, dt, seconds) = runs[tag]
    assert st.shape == (ITERS, C, 2) and dt.shape == (ITERS, C, 24)
    np.testing.assert_array_equal(dt[..., INT_COLS], dj[..., INT_COLS])
    assert_parity(sj, st, EXACT, f"{tag} draws")
    assert_parity(dj, dt, EXACT, f"{tag} diagnostics")
    assert seconds > 0
    # the chunk boundary falls inside the run, and the orbits are real
    assert dj[..., 6].sum() + dj[..., 7].sum() > ITERS * C


@pytest.mark.parametrize("tag", [t for _, t in ge.INTEGRATORS])
def test_record_is_the_jax_harness_record(runs, tag, tmp_path, monkeypatch):
    """JAX's ``run_one`` over the port's arrays (its engine call patched
    to return them in one chunk) writes the record ``record`` makes."""
    _, (st, dt, _) = runs[tag]
    integ = next(i for i, t in ge.INTEGRATORS if t == tag)
    rows = np.concatenate([np.zeros_like(st[:1]), st])

    def engine(*a, **kw):
        assert kw["num_iter"] == ITERS
        return jnp.asarray(rows), jnp.asarray(dt), None

    monkeypatch.setattr(wt, "run_walnuts", engine)
    frag = tmp_path / "frag.json"
    jge.run_one(LOG2D, integ, C, ITERS, str(frag), rep=REP)
    want = json.loads(frag.read_text())
    got = ge.record(st, dt)
    assert set(want) | {"grad_evals_max_chain_per_transition"} == set(got)
    assert got["chains"] == want["chains"] == C
    for k in ("ess_per_1000_grad_q0", "ess_per_1000_grad_sumsq",
              "grad_evals"):
        assert_parity(want[k], got[k], EXACT, k)
    g = dt[..., 6] + dt[..., 7]
    assert got["grad_evals_max_chain_per_transition"] == g.max(axis=1).mean()


def _fragments(slope, seed):
    """Replica records at d = 2^3..2^6 whose ESS per 1000 grads follows
    ``d^slope`` with noise, keyed like the JAX harness's fragments."""
    rng = np.random.default_rng(seed)
    frags = {}
    for log2d in range(3, 7):
        for integ, _ in ge.INTEGRATORS:
            for rep in range(2):
                eff = 100.0 * (2.0 ** log2d) ** slope * rng.uniform(0.8, 1.25)
                frags[(log2d, integ, rep)] = {
                    "chains": 8, "ess_per_1000_grad_q0": eff,
                    "ess_per_1000_grad_sumsq": eff * rng.uniform(0.2, 0.5),
                    "grad_evals": float(rng.integers(10_000, 50_000))}
    return frags


@pytest.mark.parametrize("slope,fails", [(-0.25, False), (0.3, True)])
def test_main_pools_fits_and_gates_as_the_jax_harness(slope, fails,
                                                      tmp_path, monkeypatch):
    """The same replica records through both ``main``s: JAX's reads them
    as fragments, its fixed ``/tmp`` names mapped into ``tmp_path``, the
    port's gets them from ``run_one``."""
    frags = _fragments(slope, seed=3 if fails else 4)
    local = private_fragments(jge, "/tmp/gauss_ess_", tmp_path, monkeypatch)
    for (log2d, integ, rep), rec in frags.items():
        Path(local(f"/tmp/gauss_ess_{log2d}_{integ}_{rep}.json")).write_text(
            json.dumps(rec))
    argv = ["--dmin", "3", "--dmax", "6", "--chains", "8",
            "--target-chains", "16", "--iters", "5"]
    monkeypatch.setattr(sys, "argv", ["prog"] + argv + [
        "--out", str(tmp_path / "jax.json")])
    try:
        jge.main()
        jax_exit = None
    except SystemExit as e:
        jax_exit = str(e)

    def run_one(log2d, integ, chains, iters, rep=0, **kw):
        assert chains == 8 and iters == 5 and kw["device"].type == "cpu"
        return dict(frags[(log2d, integ, rep)], rep=rep, seconds=2.0,
                    s_per_transition=0.4,
                    grad_evals_max_chain_per_transition=30.0)

    monkeypatch.setattr(ge, "run_one", run_one)
    try:
        ge.main(argv + ["--out", str(tmp_path / "port.json"),
                        "--device", "cpu"])
        port_exit = None
    except SystemExit as e:
        port_exit = str(e)
    assert port_exit == jax_exit and (port_exit is not None) == fails
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    for k in want["summary"]:
        assert_parity(want["summary"][k], got["summary"][k], EXACT, k)
    assert len(got["rows"]) == len(want["rows"]) == 4
    for w, g in zip(want["rows"], got["rows"]):
        for k in ("d", "H", "replicas", "chains_per_replica"):
            assert g[k] == w[k]
        for _, tag in ge.INTEGRATORS:
            for k, v in w[tag].items():
                assert_parity(v, g[tag][k], EXACT, f"{tag} {k}")
            assert g[tag]["s_per_transition"] == 0.4
            assert len(g[tag]["programs"]) == 2
    assert got["reduced"]["iters"] == {"default": 1000, "run": 5}
    assert got["card"] and got["seconds"] >= 0


def test_harness_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.main(["--dmin", "4", "--dmax", "4", "--iters", "2",
                 "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.run_one(4, "fixed_leapfrog", 8, 2)
    assert not (tmp_path / "x.json").exists()
    ge.main(["--dmin", "4", "--dmax", "4", "--chains", "8",
             "--target-chains", "8", "--iters", "2", "--device", "cpu",
             "--out", str(tmp_path / "x.json")])
    out = json.loads((tmp_path / "x.json").read_text())
    assert [r["d"] for r in out["rows"]] == [16]
    assert out["rows"][0]["nuts"]["programs"][0]["chains"] == 8
