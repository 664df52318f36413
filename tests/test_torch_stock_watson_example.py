"""The port's Stock-Watson harness (``walnuts_tpu_torch.examples.
stock_watson``) against the JAX harness ``examples/stock_watson.py``,
imported by path, on the CPU.

The arms' hash seeds are the JAX derivation bit for bit.  Each arm's
burn-in and sample phase equal the JAX harness's ``_stream`` calls in
``run_one``'s order (its segment 0), from the same float64 start on a
T = 12 series, integers equal and floats within ``EXACT``; the pooled
warmup phase within ``ADAPTIVE``.  ``summarize`` follows the JAX
harness's arithmetic (numpy quantiles, ``walnuts_tpu.diagnostics``'
split-Rhat and ESS).  The gate, the refusal of a truncated ring, and
``run_arm`` raising without a card unless asked for the CPU."""

import importlib.util
import json
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.diagnostics import ess as jax_ess
from walnuts_tpu.diagnostics import split_rhat as jax_split_rhat
from walnuts_tpu_torch.examples import stock_watson as sw
from walnuts_tpu_torch.sampler.megakernel import MState, mstate_to_numpy
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_stock_watson_example", REPO / "examples" / "stock_watson.py")
jsw = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jsw)

TAGS = [c[0] for c in sw.CONFIGS]
# m cut as in test_torch_stock_watson.py, so that a T = 12 arm completes
# its transitions in a few hundred rounds
M_CUT = {"walnuts_d": 4, "walnuts_r2p": 4, "nuts": 6}
C = 8


@pytest.fixture(scope="module")
def sw12(tmp_path_factory):
    """A T = 12 series (the first 12 rows of swdata.json), D = 36."""
    _, y = tw.targets.load_sw_data()
    path = tmp_path_factory.mktemp("sw") / "sw12.json"
    path.write_text(json.dumps({"T": 12, "y": y[:12].tolist()}))
    return str(path)


def _jax_key(tag):
    return jax.random.PRNGKey(zlib.crc32(tag.encode()) & 0x7FFFFFFF)


def _cfgs(tag):
    row, = [c for c in sw.CONFIGS if c[0] == tag]
    _, integ, h0, igr, _, _ = row
    return (wt.WalnutsConfig(m=M_CUT[tag], integrator=integ,
                             igr=wt.IntegratorConfig(**igr)),
            tw.WalnutsConfig(m=M_CUT[tag], integrator=integ,
                             igr=tw.IntegratorConfig(**igr)), h0)


def _assert_states_equal(want, got, contract, name):
    port = mstate_to_numpy(got)
    for field in MState._fields:
        if field in ("p2h", "p2d"):
            continue
        a, b = np.asarray(getattr(want, field)), port[field]
        assert a.shape == b.shape, (name, field)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64),
                                          err_msg=f"{name} {field}")
        else:
            np.testing.assert_allclose(b, a.astype(np.float64),
                                       err_msg=f"{name} {field}", **contract)


@pytest.mark.parametrize("tag", TAGS)
def test_arm_seeds_are_the_jax_harness_derivation(tag):
    key = _jax_key(tag)
    keys = {"warmup": key, "burnin": jax.random.fold_in(key, 1),
            "sample": jax.random.fold_in(jax.random.fold_in(key, 2), 0)}
    want = {k: int(jax.random.randint(jax.random.fold_in(v, 777), (1,), 0,
                                      2 ** 30, jnp.int32)[0])
            for k, v in keys.items()}
    assert sw.arm_seeds(tag) == want


def test_start_points_are_the_jax_harness_draws():
    mode = np.random.default_rng(9).normal(size=36).astype(np.float32)
    want = np.asarray(jnp.asarray(mode)[None, :] + 0.5 * jax.random.normal(
        jax.random.PRNGKey(0), (C, 36), jnp.float32))
    got = sw.start_point("mode", C, 36, torch.from_numpy(mode))
    assert got.dtype == torch.float32
    # threefry.normal: within a few ulp of XLA's log1p
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (C, 36),
                                         jnp.float32, -2.0, 2.0))
    np.testing.assert_array_equal(sw.start_point("stan", C, 36).numpy(), want)


@pytest.mark.parametrize("tag", TAGS)
def test_phases_equal_the_jax_harness_streams(sw12, tag):
    """Burn-in, then the sample phase (at most 500 draws: the JAX
    harness's segment 0), from one float64 start."""
    cfg_j, cfg_t, h0 = _cfgs(tag)
    burnin, iters = 2, 3
    q0 = 0.3 * np.random.default_rng(5).normal(size=(C, 36))
    key = _jax_key(tag)
    h = jnp.full((C,), h0, jnp.float32)
    d = jnp.full((C,), 0.3, jnp.float32)
    tj = wt.targets.stock_watson(sw12, proper=True)
    burn = jsw._stream(jax.random.fold_in(key, 1), jnp.asarray(q0), h, d,
                       target=tj, cfg=cfg_j, num_iter=burnin, ring_rows=8,
                       tag=tag + ":burnin")
    samp = jsw._stream(jax.random.fold_in(jax.random.fold_in(key, 2), 0),
                       burn.qc, h, d, target=tj, cfg=cfg_j, num_iter=iters,
                       tag=tag + ":sample0")
    phases, _, _ = sw.run_phases(
        tag, torch.from_numpy(q0),
        target=tw.targets.stock_watson(sw12, proper=True), cfg=cfg_t, h0=h0,
        iters=iters, burnin=burnin, device="cpu")
    assert list(phases) == ["burnin", "sample"]
    _assert_states_equal(burn, phases["burnin"].state, EXACT, "burn-in")
    _assert_states_equal(samp, phases["sample"].state, EXACT, "sample")
    st = phases["sample"].state
    assert tuple(st.samples.shape) == (iters, C, 36)
    assert int(st.it.min()) >= iters and bool(torch.isfinite(st.samples).all())


def test_warmup_phase_follows_the_jax_harness(sw12):
    """The pooled warmup (the adaptive arms under ``--warmup N``) and the
    tuning it hands on, within the contract for runs that adapt."""
    tag = "walnuts_d"
    cfg_j, cfg_t, h0 = _cfgs(tag)
    q0 = 0.3 * np.random.default_rng(6).normal(size=(C, 36))
    want = jsw._stream(_jax_key(tag), jnp.asarray(q0),
                       jnp.full((C,), h0, jnp.float32),
                       jnp.full((C,), 0.3, jnp.float32),
                       target=wt.targets.stock_watson(sw12, proper=True),
                       cfg=cfg_j, num_iter=2,
                       warmup=wt.WarmupConfig(warmup_iter=2, pooled=True),
                       ring_rows=8, tag=tag + ":warmup")
    phases, h, d = sw.run_phases(
        tag, torch.from_numpy(q0),
        target=tw.targets.stock_watson(sw12, proper=True), cfg=cfg_t, h0=h0,
        iters=1, burnin=0, warmup=2, device="cpu")
    assert list(phases) == ["warmup", "sample"]
    _assert_states_equal(want, phases["warmup"].state, ADAPTIVE, "warmup")
    np.testing.assert_allclose(h.numpy(), np.asarray(want.h_cur), **ADAPTIVE)
    np.testing.assert_allclose(d.numpy(), np.asarray(want.delta_cur),
                               **ADAPTIVE)


def _jax_summary(gen, T):
    """``examples/stock_watson.py:364-399``, the JAX harness's
    statistics of a draw cube."""
    bands = {}
    for name, sl in [("sigma", slice(0, 1)), ("z", slice(1, T)),
                     ("x", slice(T, 2 * T)), ("tau", slice(2 * T, 3 * T))]:
        block = gen[:, :, sl].reshape(-1, sl.stop - sl.start)
        bands[name] = {q: np.quantile(block, p, axis=0).mean()
                       for q, p in (("q10", 0.1), ("q50", 0.5),
                                    ("q90", 0.9))}
    dg = gen.shape[2]
    rh = np.empty((dg,), np.float64)
    for lo in range(0, dg, 64):
        rh[lo:lo + 64] = np.asarray(jax_split_rhat(
            jnp.asarray(gen[:, :, lo:lo + 64], jnp.float32)))
    iact = {}
    for ci in np.argsort(rh)[-4:][::-1]:
        e = float(np.asarray(jax_ess(jnp.asarray(gen[:, :, int(ci)],
                                                 jnp.float32))))
        iact[int(ci)] = gen.shape[0] * gen.shape[1] / max(e, 1.0)
    return bands, rh, iact


@pytest.mark.parametrize("T", [12, 70])
def test_summarize_follows_the_jax_harness_arithmetic(T):
    """On a numpy-seeded cube whose chains differ in mean and scale by
    coordinate (T = 70 splits each block into ``BLOCK``-coordinate
    chunks): bands within 1e-12 (float64 quantiles), split-Rhat within
    1e-5 (float32 sums in another order), the argmax coordinate and the
    slowest coordinates equal, IACT within its 0.1 rounding."""
    rng = np.random.default_rng(11)
    N = 201
    walk = np.cumsum(rng.normal(size=(N, C, 3 * T)), axis=0)
    gen = (rng.normal(size=(N, C, 3 * T))
           + np.linspace(0.0, 0.3, 3 * T) * walk / np.sqrt(N)
           + rng.normal(size=(1, C, 3 * T)) * np.linspace(0, 0.5, 3 * T))
    gen = gen.astype(np.float32).astype(np.float64)
    bands, rh, iact = _jax_summary(gen, T)
    got = sw.summarize(torch.from_numpy(gen), T)
    for k in bands:
        for q in bands[k]:
            np.testing.assert_allclose(got["bands"][k][q], bands[k][q],
                                       rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["max_split_rhat_all_coords"], rh.max(),
                               rtol=1e-5)
    np.testing.assert_allclose(got["max_split_rhat_subsampled"],
                               rh[::50].max(), rtol=1e-5)
    assert got["argmax_rhat_coord"] == int(np.argmax(rh))
    assert list(got["iact_slowest_coords"]) == list(iact)
    for ci, v in iact.items():
        assert abs(got["iact_slowest_coords"][ci] - v) <= 0.05 + 1e-4 * v


def _fragment(rhat):
    q = {"q10": 0.0, "q50": 1.0, "q90": 2.0}
    return {"bands": {k: dict(q) for k in ("sigma", "z", "x", "tau")},
            "grad_evals": 1.0, "seconds": 1.0, "kernel_launches": 0,
            "max_split_rhat_all_coords": rhat}


@pytest.mark.parametrize("model,worst,fails", [
    ("proper", 1.01, False), ("proper", 1.05, True),
    ("reference", 3.0, False)])
def test_gate_fails_the_proper_model_at_split_rhat_1_05(
        tmp_path, monkeypatch, capsys, model, worst, fails):
    rhats = {"walnuts_d": 1.0, "walnuts_r2p": worst, "nuts": 1.002}
    monkeypatch.setattr(sw, "run_arm",
                        lambda tag, **kw: (_fragment(rhats[tag]), None))
    monkeypatch.setattr(sw, "card_name", lambda: "card, 1 W")
    out = tmp_path / "out.json"
    argv = ["--model", model, "--out", str(out)]
    if fails:
        with pytest.raises(SystemExit) as e:
            sw.main(argv)
        assert e.value.code != 0
    else:
        sw.main(argv)
    res = json.loads(out.read_text())
    assert res["max_split_rhat_all"] == worst
    assert res["gate_stat_per_arm"] == rhats and res["card"] == "card, 1 W"
    assert res["band_gap_walnutsD_vs_r2p"] == 0.0
    assert res["runs"]["nuts"]["stamp"]["m"] == 12
    assert ("NOTE: reference model" in capsys.readouterr().out) == (
        model == "reference")


def test_stream_refuses_a_truncated_ring(sw12):
    _, cfg, h0 = _cfgs("nuts")
    q0 = torch.zeros(C, 36, dtype=torch.float64)
    h = torch.full((C,), h0, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="truncated ring"):
        sw.stream(5, q0, h, torch.full_like(h, 0.3),
                  target=tw.targets.stock_watson(sw12, proper=True), cfg=cfg,
                  num_iter=50, rounds=16, max_inv=2, device="cpu")


def test_run_arm_runs_on_the_card_unless_asked_for_the_cpu(sw12):
    kw = dict(chains=4, iters=4, burnin=1, m=M_CUT["nuts"], data_path=sw12,
              init="stan", dtype=torch.float64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sw.run_arm("nuts", **kw)
    res, st = sw.run_arm("nuts", device="cpu", **kw)
    jax_keys = set(json.loads((REPO / "examples" / "out_stock_watson.json")
                              .read_text())["runs"]["nuts"]) - {"stamp"}
    assert jax_keys <= set(res)
    assert res["retained_draws"] == 16 and res["kernel_launches"] == 0
    assert list(res["phases"]) == ["burnin", "sample"]
    assert res["phases"]["sample"]["grad_evals"] == int(st.grad_ct.sum())
    assert res["grad_evals"] == sum(
        p["grad_evals"] for p in res["phases"].values())
    assert tuple(st.samples.shape) == (4, 4, 36)
    assert bool(torch.isfinite(st.samples).all())
