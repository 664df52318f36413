"""The port's config-5 harness (``walnuts_tpu_torch.examples.
highdim_variants``) against the JAX harness ``examples/
highdim_variants.py``, imported by path, on the CPU; and the port's
figure script (``walnuts_tpu_torch.examples.make_figs``) over the port's
committed artifacts.

The ill-conditioned variances are ``jnp.logspace`` bit for bit in both
dtypes; the targets equal the JAX harness's (float64 under ``EXACT``,
float32 bit for bit but for the sums over D); every arm at D = 16,
float64, equals the JAX harness's engine calls (``:114-143``) under
``EXACT``, the implicit midpoint across a chunk boundary; the record
equals the JAX ``run_arm``'s on the same arrays (its engine calls
patched to return them) and the gate exits as the JAX ``main`` does on
the same fragments; ``--devices 2`` (two gloo ranks) gives one
process's draws."""

import importlib.util
import json
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu.sampler as wts
from walnuts_tpu_torch.examples import highdim_variants as hv
from walnuts_tpu_torch.examples import make_figs as mf
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

from test_torch_gaussian_ess_example import private_fragments

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jhv = _load("highdim_variants")

D, C, ITERS, CHUNK, M = 16, 8, 4, 2, 9
# integer diagnostics columns: the scan engine's (24 columns) and
# generic NUTS' (12)
INT_COLS = {"im": [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22],
            "iso": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]}
Z_KEYS = ("z_mean_q0", "ess_q0", "z_mean_qlast", "ess_qlast", "z_radius_sq",
          "ess_radius_sq", "sd_q0", "radius_sq_mean", "radius_sq_expected",
          "grad_evals", "H")


@pytest.mark.parametrize("num", [2, 16, 1000, 10000])
def test_logspace_is_jnp_logspace_bit_for_bit(num):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        want = np.asarray(jnp.logspace(0.0, 4.0, num, dtype=jdt))
        got = hv.logspace(0.0, 4.0, num, tdt).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _jax_eval(arm, q):
    t = jhv.make_target(arm, q.shape[-1])
    lp, g = t.logp_grad(jnp.asarray(q))
    return [np.asarray(x) for x in (lp, g, t.generated(jnp.asarray(q)))]


@pytest.mark.parametrize("arm", hv.ARMS)
def test_target_equals_the_jax_harness(arm):
    """float64 (x64, as the tests run JAX) under EXACT; float32 (JAX
    without x64, as its harness runs) bit for bit but for the two sums
    over D, which follow the backends' summation orders."""
    dim = 1000
    sd = np.sqrt(np.logspace(0.0, 4.0, dim)) if arm.endswith("_illcond") \
        else np.ones(dim)
    q = sd * np.random.default_rng(5).normal(size=(C, dim))
    t = hv.make_target(arm, dim, torch.float64)
    lp, g = t.logp_grad(torch.from_numpy(q))
    got = [x.numpy() for x in (lp, g, t.generated(torch.from_numpy(q)))]
    for name, w, x in zip(("logp", "grad", "generated"), _jax_eval(arm, q),
                          got):
        assert_parity(w, x, EXACT, f"{arm} f64 {name}")

    q32 = q.astype(np.float32)
    with jax.enable_x64(False):
        want = _jax_eval(arm, q32)
        var = jnp.logspace(0.0, 4.0, dim)
    t = hv.make_target(arm, dim, torch.float32)
    lp, g = t.logp_grad(torch.from_numpy(q32))
    gen = t.generated(torch.from_numpy(q32)).numpy()
    assert gen.dtype == np.float32 and want[2].dtype == np.float32
    np.testing.assert_array_equal(g.numpy(), want[1])
    np.testing.assert_array_equal(gen[:, :2], want[2][:, :2])
    np.testing.assert_allclose(lp.numpy(), want[0], rtol=2e-6)
    np.testing.assert_allclose(gen[:, 2], want[2][:, 2], rtol=2e-6)
    if arm.endswith("_illcond"):
        np.testing.assert_array_equal(hv.variances(arm, dim).numpy(),
                                      np.asarray(var))


@pytest.mark.parametrize("arm", hv.ARMS)
def test_start_is_the_jax_harness_draw(arm):
    """``:104-109`` in float32: the normals within threefry's few-ulp
    contract, the ill-conditioned scale bit for bit."""
    key = jax.random.PRNGKey(sum(map(ord, arm)))
    z = jax.random.normal(key, (C, D), jnp.float32)
    want = z if arm.endswith("_std") else jnp.sqrt(
        jnp.logspace(0.0, 4.0, D, dtype=jnp.float32)) * z
    want = np.asarray(want)
    got = hv.start(arm, C, D).numpy()
    assert got.dtype == np.float32
    assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))
    assert np.mean(got == want) > 0.8


def _jax_arm(arm, q0, iters, chunk, m):
    """``highdim_variants.py:99-143`` from ``q0`` (one device): the draws
    ``[iters, C, 3]`` and the diagnostics."""
    t = jhv.make_target(arm, q0.shape[-1])
    key = jax.random.PRNGKey(sum(map(ord, arm)))
    h = 1.4 * q0.shape[-1] ** -0.25
    if arm.startswith("im_"):
        cfg = wt.WalnutsConfig(m=m, integrator="adapt_implicit_midpoint_d")
        wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                             adapt_delta=False)
        state = None
        parts, dparts = [], []
        done = 0
        while done < iters:
            n = min(chunk, iters - done)
            s, dg, state = wt.run_walnuts(
                jax.random.fold_in(key, 7000 + done), q0, target=t,
                cfg=cfg, warmup=wu, num_iter=n, h0=h, delta0=0.3,
                resume_state=state)
            parts.append(np.asarray(s, np.float64)[1:])
            dparts.append(np.asarray(dg))
            done += n
        return np.concatenate(parts), np.concatenate(dparts)
    s, dg = wts.run_generic_nuts(
        jax.random.fold_in(key, 1), q0, target=t,
        kernel=wts.IsokineticKernel(), h_macro=h, delta=0.2,
        num_iter=iters, m=m)
    return np.asarray(s, np.float64)[1:], np.asarray(dg)


@pytest.fixture(scope="module")
def runs():
    """Every arm on both sides at D = 16, float64, from one start."""
    out = {}
    for arm in hv.ARMS:
        q0 = hv.start(arm, C, D, torch.float64)
        iters = ITERS if arm.startswith("im_") else ITERS - 1
        want = _jax_arm(arm, jnp.asarray(q0.numpy()), iters, CHUNK, M)
        got = hv.sample(arm, q0, iters=iters, chunk=CHUNK, m=M, device="cpu")
        out[arm] = (iters, want, got)
    return out


@pytest.mark.parametrize("arm", hv.ARMS)
def test_arm_equals_the_jax_harness(runs, arm):
    iters, (sj, dj), (st, dt, grads, seconds, syncs) = runs[arm]
    st, dt = st.numpy(), dt.numpy()
    assert st.shape == (iters, C, 3) and seconds > 0
    cols = INT_COLS[arm.split("_")[0]]
    np.testing.assert_array_equal(dt[..., cols], dj[..., cols])
    assert_parity(sj, st, EXACT, f"{arm} draws")
    assert_parity(dj, dt, EXACT, f"{arm} diagnostics")
    want_grads = (dj[..., 6] + dj[..., 7] if arm.startswith("im_")
                  else dj[..., 7])
    np.testing.assert_array_equal(grads.numpy(), want_grads)
    if arm.startswith("im_"):
        # every micro step's solve iterates at least once and syncs per
        # iteration; the slowest chain's gradients bound them
        assert 0 < syncs and dj[..., 6].sum() > 0
    else:
        assert syncs == 0


@pytest.mark.parametrize("arm", hv.ARMS)
def test_record_is_the_jax_harness_record(runs, arm, tmp_path, monkeypatch):
    """JAX's ``run_arm`` over the port's arrays (its engine calls patched
    to return them, chunk by chunk) writes the record ``record`` makes."""
    iters, _, (st, dt, grads, seconds, syncs) = runs[arm]
    st, dt = st.numpy(), dt.numpy()
    zero = np.zeros_like(st[:1])

    def walnuts(key, q0, *, num_iter, resume_state, **kw):
        done = 0 if resume_state is None else resume_state
        rows = np.concatenate([zero, st[done:done + num_iter]])
        return rows, dt[done:done + num_iter], done + num_iter

    def generic(key, q0, *, num_iter, **kw):
        assert num_iter == iters
        return np.concatenate([zero, st]), dt

    monkeypatch.setattr(wt, "run_walnuts", walnuts)
    monkeypatch.setattr(wts, "run_generic_nuts", generic)
    args = Namespace(dim=D, chains=C, devices=1, iters=iters, chunk=CHUNK,
                     m=M, frag=str(tmp_path / "frag.json"))
    jhv.run_arm(arm, args)
    want = json.loads((tmp_path / "frag.json").read_text())
    got = hv.record(arm, st, grads, seconds, dim=D, iters=iters,
                    syncs=syncs)
    assert set(want) <= set(got)
    for k in ("arm", "dim", "chains", "devices", "iters"):
        assert got[k] == want[k]
    for k in Z_KEYS:
        assert_parity(want[k], got[k], EXACT, k)
    assert got["s_per_transition"] == seconds / iters
    assert ("fixed_point_syncs_per_transition" in got) == \
        arm.startswith("im_")


@pytest.mark.parametrize("worst", [1.5, 4.5])
def test_gate_exits_as_the_jax_harness(worst, tmp_path, monkeypatch):
    """The same arm records through both ``main``s: JAX's reads them as
    fragments, its fixed ``/tmp`` names mapped into ``tmp_path``, the
    port's gets them from ``run_arm``."""
    rng = np.random.default_rng(int(worst * 10))
    recs = {}
    for i, arm in enumerate(hv.ARMS):
        z = rng.uniform(-1.0, 1.0, size=3)
        if i == 2:
            z[1] = -worst
        recs[arm] = {"arm": arm, "dim": D, "z_mean_q0": z[0],
                     "z_mean_qlast": z[1], "z_radius_sq": z[2],
                     "seconds": 3.0, "s_per_transition": 0.75}
    local = private_fragments(jhv, "/tmp/highdim_", tmp_path, monkeypatch)
    for arm, rec in recs.items():
        Path(local(f"/tmp/highdim_{arm}_{D}.json")).write_text(json.dumps(rec))
    monkeypatch.setattr(sys, "argv", [
        "prog", "--dim", str(D), "--iters", "4",
        "--out", str(tmp_path / "jax.json")])
    try:
        jhv.main()
        jax_exit = None
    except SystemExit as e:
        jax_exit = str(e)

    def run_arm(arm, *, dim, iters, device, **kw):
        assert dim == D and iters == 4 and device.type == "cpu"
        return dict(recs[arm])

    monkeypatch.setattr(hv, "run_arm", run_arm)
    try:
        hv.main(["--dim", str(D), "--iters", "4", "--device", "cpu",
                 "--out", str(tmp_path / "port.json")])
        port_exit = None
    except SystemExit as e:
        port_exit = str(e)
    assert port_exit == jax_exit and (port_exit is not None) == (worst > 4)
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got["max_abs_z_all"] == want["max_abs_z_all"] == worst
    assert got["gate_z"] == want["gate_z"]
    for arm in hv.ARMS:
        assert got["runs"][arm]["max_abs_z"] == want["runs"][arm]["max_abs_z"]
    assert got["reduced"]["iters"] == {"default": 400, "run": 4}
    assert got["reduced"]["projected_full_seconds"] == 4 * 0.75 * 400


@pytest.mark.parametrize("arm", ["im_std", "iso_std"])
def test_two_ranks_give_one_process_draws(arm):
    kw = dict(dim=D, chains=C, iters=ITERS, chunk=CHUNK, m=M,
              dtype=torch.float64, device="cpu")
    s1, g1, _, _ = hv.draws(arm, **kw)
    s2, g2, _, syncs = hv.draws(arm, devices=2, **kw)
    np.testing.assert_array_equal(g2.numpy(), g1.numpy())
    np.testing.assert_array_equal(s2.numpy(), s1.numpy())
    assert (syncs > 0) == arm.startswith("im_")


def test_harness_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hv.main(["--dim", "8", "--iters", "1",
                 "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hv.run_arm("iso_std", dim=8, chains=2, iters=1)
    assert not (tmp_path / "x.json").exists()


def test_make_figs_renders_the_ports_artifacts(tmp_path):
    mf.main(dst=tmp_path)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["fig_funnel_transient.png", "fig_gauss_ess.png",
                     "fig_gauss_transient.png", "fig_stock_watson_bands.png"]
    for p in tmp_path.iterdir():
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rows = json.loads((mf.HERE / "out_gaussian_ess.json").read_text())["rows"]
    dims, series = mf.fig_gauss_ess(dst=tmp_path)
    assert dims == [r["d"] for r in rows] and len(dims) == 11
    for fn in mf.ESS_FNS:
        for tag in mf.TAGS:
            assert series[fn][tag] == [r[tag][fn] for r in rows]
    # the port has no scan-engine transient artifact: the figure says so
    assert mf.fig_funnel_transient(dst=tmp_path) == \
        (mf.HERE / "out_funnel_transient.json").exists()
    assert mf.HERE == REPO / "walnuts_tpu_torch" / "examples"
