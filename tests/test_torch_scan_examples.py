"""The port's gaussian-transient harness, its merge script and the funnel
orbit-length harness (``walnuts_tpu_torch.examples``) against the JAX
harnesses ``examples/gaussian_transient.py``,
``examples/merge_gaussian_transient.py`` and
``examples/funnel_orbit_len.py``, imported by path, on the CPU.

The rows' seeds are the JAX harnesses' keys bit for bit; the orbit-length
study's start draws the JAX harness's normals (bit for bit on most
entries, within a few ulp on the rest: XLA's CPU ``log1p`` differs from
torch's, ``tests/test_torch_threefry.py``) through the same arithmetic.
The gaussian-transient rows at d = 16, float64, equal the JAX harness's
``main`` (its ``wt.run_walnuts`` call at ``:90``) under ``EXACT``; the
port's merge equals the JAX script's on the same fragments; the
orbit-length run equals the JAX harness's ``wt.run_walnuts`` call
(``:73-76``) under ``EXACT`` and its record equals the JAX ``run_one``'s
on the same arrays.  Every harness raises without a card unless asked
for the CPU."""

import importlib
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
from walnuts_tpu_torch.examples import funnel_orbit_len as fol
from walnuts_tpu_torch.examples import gaussian_transient as gt
from walnuts_tpu_torch.examples import merge_gaussian_transient as mgt
from walnuts_tpu_torch.utils import threefry
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jgt = _load("gaussian_transient")
jmgt = _load("merge_gaussian_transient")
jfol = _load("funnel_orbit_len")

D_ROW, C, ITERS = 16, 8, 4
ARM_FLOATS = ("H", "frac_inside_by_iter", "micro_h_min_by_iter",
              "micro_h_max_by_iter", "cum_grad_evals_mean")


def _run_main(main, argv, monkeypatch):
    """A JAX harness's ``main`` with ``argv``; its gate's exit is kept."""
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    try:
        main()
    except SystemExit as e:
        return e
    return None


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """The JAX harness's and the port's fragments at d = 16, float64."""
    tmp = tmp_path_factory.mktemp("gt")
    argv = ["--dims", str(D_ROW), "--chains", str(C), "--iters", str(ITERS),
            "--dtype", "float64"]
    with pytest.MonkeyPatch.context() as mp:
        _run_main(jgt.main, argv + ["--out", str(tmp / "jax.json")], mp)
    try:
        gt.main(argv + ["--out", str(tmp / "port.json"), "--device", "cpu"])
    except SystemExit:
        pass
    return (json.loads((tmp / "jax.json").read_text()),
            json.loads((tmp / "port.json").read_text()), tmp)


def test_row_seeds_are_the_jax_harness_keys():
    for d in [2 ** k for k in range(11, 16)] + [D_ROW]:
        np.testing.assert_array_equal(
            threefry.PRNGKey(d).numpy().astype(np.uint32),
            np.asarray(jax.random.PRNGKey(d)))
    assert [a[:2] for a in gt.ARMS] == [a[:2] for a in jgt.ARMS]
    assert [a[2] for a in gt.ARMS] == [a[2] for a in jgt.ARMS]


@pytest.mark.parametrize("tag", [a[0] for a in gt.ARMS])
def test_rows_equal_the_jax_harness(rows, tag):
    want, got, _ = rows
    (w,), (g,) = want, got
    for k in ("d", "chains", "dtype"):
        assert g[k] == w[k]
    np.testing.assert_allclose(g["band"], w["band"], rtol=1e-15)
    assert g[tag]["iters_to_95pct_inside"] == w[tag]["iters_to_95pct_inside"]
    for k in ARM_FLOATS:
        assert_parity(w[tag][k], g[tag][k], EXACT, f"{tag} {k}")
    assert g[tag]["seconds"] > 0 and g[tag]["s_per_transition"] == \
        g[tag]["seconds"] / ITERS
    assert g["card"] and set(w[tag]) <= set(g[tag])


def test_merge_equals_the_jax_script(rows, monkeypatch):
    """Two port fragments (d = 16 and 24) through both merge scripts, with
    the float64 cross-check attached."""
    _, _, tmp = rows
    frag2 = tmp / "port24.json"
    gt.main(["--dims", "24", "--chains", str(C), "--iters", str(ITERS),
             "--out", str(frag2), "--device", "cpu"])
    frags = [str(frag2), str(tmp / "port.json")]
    extra = ["--f64-crosscheck", str(tmp / "port.json")]
    err = _run_main(jmgt.main, frags + extra + ["--out", str(tmp / "mj.json")],
                    monkeypatch)
    try:
        mgt.main(frags + extra + ["--out", str(tmp / "mp.json")])
        port_err = None
    except SystemExit as e:
        port_err = e
    assert (err is None) == (port_err is None)
    want = json.loads((tmp / "mj.json").read_text())
    got = json.loads((tmp / "mp.json").read_text())
    assert got == want
    assert got["summary"]["dims"] == [16, 24]


def _jax_start(chains):
    """``funnel_orbit_len.py:63-68`` in float32."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    w0 = 3.0 * jax.random.normal(k1, (chains, 1), jnp.float32)
    x0 = jnp.exp(0.5 * w0) * jax.random.normal(k2, (chains, 10), jnp.float32)
    return np.asarray(jnp.concatenate([w0, x0], axis=-1)), (k1, k2)


def test_orbit_len_start_is_the_jax_harness_draw(monkeypatch):
    want, (k1, k2) = _jax_start(128)
    keys = threefry.split(threefry.PRNGKey(0))
    np.testing.assert_array_equal(keys[0].numpy().astype(np.uint32),
                                  np.asarray(k1))
    np.testing.assert_array_equal(keys[1].numpy().astype(np.uint32),
                                  np.asarray(k2))
    got = fol.start(128).numpy()
    assert got.dtype == np.float32 and got.shape == (128, 11)
    # the port's own normals: within threefry's few-ulp contract, which
    # exp(0.5 w0) carries into x (|w0| up to ~9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    # JAX's normals through the port's arithmetic: omega bit for bit; x
    # within 2 ulp (torch's float32 exp against XLA's: 12.6% of x differ
    # in the last bits, measured)
    def jax_normal(key, shape, dtype):
        k = jnp.asarray(key.numpy().astype(np.uint32))
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32)))

    monkeypatch.setattr(fol.threefry, "normal", jax_normal)
    got = fol.start(128).numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))


H = 0.3


@pytest.fixture(scope="module")
def orbit_run():
    """The port's and JAX's runs at one H, 8 chains, 3 iterations, f64."""
    q0 = fol.start(C, torch.float64)
    want = wt.run_walnuts(
        jax.random.PRNGKey(fol.SEED), jnp.asarray(q0.numpy()),
        target=wt.targets.funnel(11),
        cfg=wt.WalnutsConfig(m=12, record_orbit_stats=True),
        warmup=wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                               adapt_delta=False),
        num_iter=3, h0=H, delta0=0.1, collect_orbit_stats=True)
    got = fol.run(H, q0, 3, device="cpu")
    return want, got


def test_orbit_len_run_equals_the_jax_harness_call(orbit_run):
    (sj, dj, _, oj, xj), (st, dt, ot, xt, seconds) = orbit_run
    for name, a, b in (("samples", sj, st), ("diagnostics", dj, dt),
                       ("omin", oj, ot), ("omax", xj, xt)):
        assert_parity(np.asarray(a), b.numpy(), EXACT, name)
    assert seconds > 0


def test_orbit_len_record_is_the_jax_harness_record(orbit_run, tmp_path,
                                                    monkeypatch):
    """JAX's ``run_one`` over the port's arrays (its engine call patched
    to return them) writes the record ``row_stats`` makes."""
    _, (st, dt, ot, xt, _) = orbit_run
    port = tuple(jnp.asarray(x.numpy()) for x in (st, dt)) + (None,) + tuple(
        jnp.asarray(x.numpy()) for x in (ot, xt))
    monkeypatch.setattr(wt, "run_walnuts", lambda *a, **k: port)
    jfol.run_one(H, C, 3, str(tmp_path / "frag.json"))
    want = json.loads((tmp_path / "frag.json").read_text())
    got = json.loads(json.dumps(fol.row_stats(H, st, dt, ot, xt)))
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert jfol.HS == fol.HS


def test_orbit_len_main_writes_the_artifact(tmp_path):
    out = tmp_path / "o.json"
    fol.main(["--chains", "4", "--iters", "1", "--out", str(out),
              "--device", "cpu"])
    res = json.loads(out.read_text())
    assert [r["H"] for r in res["rows"]] == fol.HS and res["card"]
    assert res["reduced"]["iters"] == {"default": 400, "run": 1}
    assert res["reduced"]["projected_full_seconds"] == pytest.approx(
        400 * sum(r["s_per_transition"] for r in res["rows"]))


HARNESSES = {
    "gaussian_transient": ["--dims", "8", "--chains", "2", "--iters", "1"],
    "funnel_orbit_len": ["--chains", "2", "--iters", "1"],
    "funnel": ["--dim", "3", "--chains", "2", "--iters", "2",
               "--warmup", "1"],
    "funnel_transient": ["--chains", "2", "--iters", "1"],
    "funnel_transient native": ["--engine", "native", "--iters", "1"],
}


@pytest.mark.parametrize("name", sorted(HARNESSES))
def test_harness_runs_on_the_card_unless_asked_for_the_cpu(name, tmp_path,
                                                           monkeypatch):
    mod = importlib.import_module(
        "walnuts_tpu_torch.examples." + name.split()[0])
    ran = []
    monkeypatch.setattr(mod, "card_name", lambda: ran.append(1) or "card")
    argv = HARNESSES[name] + ["--out", str(tmp_path / "o.json")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not ran and not (tmp_path / "o.json").exists()
