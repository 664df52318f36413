"""The port's isokinetic line against the JAX package's on the CPU, in
float64 with x64 on: the isokinetic ops (``ops/isokinetic.py``), the
step kernels (``sampler/kernels.py``) and generic-step NUTS
(``sampler/generic_nuts.py``).  Inputs are made with numpy from a seed;
draws come from the same threefry keys.  The contract is
``walnuts_tpu_torch.utils.parity.EXACT`` (integers equal, floats within
rtol 1e-9 / atol 1e-12); NaN and infinite entries must sit at the same
places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.ops import isokinetic as jiso
from walnuts_tpu.sampler import kernels as jkern
from walnuts_tpu_torch.ops import isokinetic as tiso
from walnuts_tpu_torch.sampler import kernels as tkern
from walnuts_tpu_torch.utils import threefry as tf
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

torch.set_num_threads(2)

TARGETS = {"corr_gauss": lambda m: m.targets.corr_gauss(0.95),
           "std_gauss5": lambda m: m.targets.std_gauss(5)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(want, got, label=""):
    """``got`` against ``want`` under EXACT, non-finite entries equal."""
    want, got = np.asarray(_np(want)), np.asarray(_np(got))
    assert want.shape == got.shape, (label, want.shape, got.shape)
    if want.dtype.kind == "f":
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=label)
        np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=label)
        want, got = want[fin], got[fin]
    assert_parity(want, got, EXACT, label)


def _same_tree(want, got, label=""):
    for i, (a, b) in enumerate(zip(want, got)):
        if isinstance(a, tuple):
            _same_tree(a, b, f"{label}[{i}]")
        else:
            _same(a, b, f"{label}[{i}]")


def _same_step(want, got, h, label):
    """A step's ``(state, lwt, StepStats)`` under EXACT, except
    ``c_obs = |err| * n^2 / h^3``: it scales an energy error that is a
    small difference of O(1) terms (``lp - W + H0``, with ``W`` a sum
    over up to 2^c micro steps), so its absolute error is that of the
    energy error, held to EXACT's atol, times the same ``n^2 / h^3``
    (``n <= 2^If``)."""
    _same_tree(want[0], got[0], f"{label} state")
    _same(want[1], got[1], f"{label} lwt")
    ws, gs = want[2], got[2]
    for f in ws._fields:
        if f != "c_obs":
            _same(getattr(ws, f), getattr(gs, f), f"{label} {f}")
    i_f = np.asarray(ws.i_f)
    bound = EXACT["atol"] * 4.0 ** i_f / h ** 3 + EXACT["rtol"] * np.abs(
        np.asarray(ws.c_obs))
    diff = np.abs(gs.c_obs.numpy() - np.asarray(ws.c_obs))
    assert np.all(diff <= bound), (label, diff, bound)


def _states(name, C=8, seed=0):
    """The same phase point as a JAX and a port ``MCState``."""
    rng = np.random.default_rng(seed)
    tj, tt = TARGETS[name](wt), TARGETS[name](tw)
    D = tj.dim
    q = rng.normal(size=(C, D))
    u = rng.normal(size=(C, D))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    lp, g = tj.logp_grad(jnp.asarray(q))
    sj = jiso.MCState(jnp.asarray(q), jnp.asarray(u), g, lp)
    st = tiso.mcstate_from_numpy(
        {f: np.asarray(v) for f, v in sj._asdict().items()})
    return tj, tt, sj, st


@pytest.mark.parametrize("seed", [0, 3])
def test_refresh_and_partial_refresh_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    for jd, td in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        uj = jiso.refresh_u(jk, (16, 7), jd)
        ut = tiso.refresh_u(tk, (16, 7), td)
        assert ut.dtype == td
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj),
                                   rtol=1e-5 if td == torch.float32 else 1e-12,
                                   atol=1e-6 if td == torch.float32 else 1e-14)
    uj = jiso.refresh_u(jk, (16, 7), jnp.float64)
    ut = torch.from_numpy(np.array(uj))
    k2j, k2t = jax.random.fold_in(jk, 1), tf.fold_in(tk, 1)
    _same(jiso.partial_refresh_u(k2j, uj, 0.7),
          tiso.partial_refresh_u(k2t, ut, 0.7), "partial")
    np.testing.assert_allclose(
        np.linalg.norm(tiso.partial_refresh_u(k2t, ut, 0.7).numpy(), axis=-1),
        1.0, atol=1e-12)


@pytest.mark.parametrize("jd,td", [(jnp.float64, torch.float64),
                                   (jnp.float32, torch.float32)])
def test_b_kick_matches_jax_with_its_edges(jd, td):
    """Ordinary kicks, a rapidity past the clip at 100 (finite in float64,
    where cosh(100) fits; non-finite in float32, where it overflows) and
    a zero gradient (a zero direction in float64; NaN in float32, where
    the 1e-300 guard is 0): the port gives what JAX gives, and flags the
    clipped kick as failed."""
    rng = np.random.default_rng(1)
    C, D = 6, 5
    u = rng.normal(size=(C, D))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    g = rng.normal(size=(C, D))
    g[2] *= 1e4          # rapidity 0.05 * |g| / 4 > 100: clipped
    g[3] = 0.0           # zero gradient
    h_half = np.full(C, 0.05)
    d = jnp.asarray(D, jd)
    want = jiso._b_kick(jnp.asarray(u, jd), jnp.asarray(g, jd),
                        jnp.asarray(h_half, jd), d)
    got = tiso._b_kick(torch.tensor(u, dtype=td), torch.tensor(g, dtype=td),
                       torch.tensor(h_half, dtype=td), float(D))
    ok = got[2].numpy()
    np.testing.assert_array_equal(ok, np.asarray(want[2]))
    assert not ok[2] and ok[[0, 1, 4, 5]].all()
    if td == torch.float64:
        assert np.isfinite(got[0][2].numpy()).all()
        np.testing.assert_allclose(got[0][3].numpy(), u[3], rtol=1e-15)
        _same_tree(want, got, "b_kick")
    else:
        assert not np.isfinite(got[0][2].numpy()).all()
        assert np.isnan(got[0][3].numpy()).all()
        for a, b in zip(want[:2], got[:2]):
            a, b = np.asarray(a), b.numpy()
            np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a))
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(TARGETS))
@pytest.mark.parametrize("err", [False, True])
def test_multisteps_match_jax(name, err):
    tj, tt, sj, st = _states(name, C=8, seed=2)
    h = np.linspace(0.02, 0.3, 8)
    n = np.array([0, 1, 3, 8, 16, 5, 0, 32], np.int32)
    fj = jiso.isokinetic_multistep_err if err else jiso.isokinetic_multistep
    ft = tiso.isokinetic_multistep_err if err else tiso.isokinetic_multistep
    want = fj(tj, sj, jnp.asarray(h), jnp.asarray(n))
    got = ft(tt, st, torch.from_numpy(h), torch.from_numpy(n))
    _same_tree(want, got, "multistep")


STEPS = ["fixed_mc_step", "adapt_mc_step_e", "adapt_mc_step_flow2"]
STEP_SIZES = {"corr_gauss": (1.2, 0.05), "std_gauss5": (3.0, 0.01)}


@pytest.mark.parametrize("name", list(TARGETS))
@pytest.mark.parametrize("step", STEPS)
def test_step_functions_match_jax(name, step):
    """Macro steps over a range of sizes whose searches end at several
    refinement levels, some with ``Ib < If`` (a log-zero weight)."""
    tj, tt, sj, st = _states(name, C=12, seed=4)
    h_max, tol = STEP_SIZES[name]
    h = np.linspace(0.05, h_max, 12)
    delta = np.full(12, tol)
    active = np.ones(12, bool)
    active[[1, 7]] = False
    want = getattr(jiso, step)(None, tj, sj, jnp.asarray(h),
                               jnp.asarray(delta), jnp.asarray(active))
    got = getattr(tiso, step)(None, tt, st, torch.from_numpy(h),
                              torch.from_numpy(delta),
                              torch.from_numpy(active))
    _same_step(want, got, h, step)
    if step != "fixed_mc_step":   # the searches reach several levels
        assert len(set(got[2].i_f.tolist())) > 2


KERNELS = {
    "iso_energy": lambda m: m.IsokineticKernel(),
    "iso_flow": lambda m: m.IsokineticKernel(variant="flow"),
    "iso_flow2": lambda m: m.IsokineticKernel(variant="flow2"),
    "iso_fixed": lambda m: m.IsokineticKernel(adaptive=False),
    "hmc_energy": lambda m: m.HMCKernel(),
    "hmc_flow": lambda m: m.HMCKernel(variant="flow"),
    "hmc_fixed": lambda m: m.HMCKernel(adaptive=False),
}


@pytest.mark.parametrize("kname", list(KERNELS))
def test_kernel_steps_match_jax(kname):
    """Each kernel's refresh and macro step, on corr_gauss(0.95)."""
    tj, tt, sj, st = _states("corr_gauss", C=10, seed=6)
    kj, kt = KERNELS[kname](jkern), KERNELS[kname](tkern)
    sj = kj.refresh(jax.random.PRNGKey(9), sj)
    st = kt.refresh(tf.PRNGKey(9), st)
    _same(sj.u, st.u, "refresh")
    st = st._replace(u=torch.from_numpy(np.array(sj.u)))
    _same(kj.ham(sj), kt.ham(st), "ham")
    h = np.linspace(0.05, 0.9, 10)
    delta = np.full(10, 0.1)
    active = np.arange(10) != 4
    want = kj.step(None, tj, sj, jnp.asarray(h), jnp.asarray(delta),
                   jnp.asarray(active))
    got = kt.step(None, tt, st, torch.from_numpy(h), torch.from_numpy(delta),
                  torch.from_numpy(active))
    _same_step(want, got, h, kname)
    _same_tree(kj.flip(sj), kt.flip(st), "flip")


C, D, M, N = 8, 5, 5, 10


@pytest.fixture(scope="module")
def generic_runs():
    """JAX ``run_generic_nuts`` with each kernel on std_gauss(5), once
    per module."""
    q0 = 0.8 * np.random.default_rng(7).normal(size=(C, D))
    out = {}
    for kname in ("iso_energy", "hmc_energy"):
        s, d = wt.sampler.run_generic_nuts(
            jax.random.PRNGKey(11), jnp.asarray(q0),
            target=wt.targets.std_gauss(D), kernel=KERNELS[kname](jkern),
            h_macro=0.5, delta=0.1, num_iter=N, m=M)
        out[kname] = (np.asarray(s), np.asarray(d))
    return q0, out


# integer-valued generic NUTS columns: NutsIter, L, a, b, aInt, bInt,
# NUTtype, gradEvals, minIf, maxIf
GEN_INT_COLS = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]


@pytest.mark.parametrize("kname", ["iso_energy", "hmc_energy"])
def test_run_generic_nuts_matches_jax(generic_runs, kname):
    q0, runs = generic_runs
    sj, dj = runs[kname]
    st, dt = tw.sampler.run_generic_nuts(
        11, q0, target=tw.targets.std_gauss(D), kernel=KERNELS[kname](tkern),
        h_macro=0.5, delta=0.1, num_iter=N, m=M, device="cpu")
    assert dt.shape == (N, C, len(tw.sampler.GENERIC_DIAG_COLS))
    np.testing.assert_array_equal(dt.numpy()[..., GEN_INT_COLS],
                                  dj[..., GEN_INT_COLS])
    assert_parity(dj, dt.numpy(), EXACT, "diagnostics")
    assert_parity(sj, st.numpy(), EXACT, "samples")
    # the runs go deep enough to exercise the merge checks and stop codes
    assert dj[..., 0].max() >= 2 and len(np.unique(dj[..., 6])) >= 2


def test_generic_transition_from_a_jax_state():
    """One transition from a JAX ``MCState`` carried across with
    ``mcstate_from_numpy``, and back with ``mcstate_to_numpy``."""
    tj, tt, sj, st = _states("corr_gauss", C=16, seed=8)
    h, dl = np.full(16, 0.4), np.full(16, 0.15)
    for kname in ("iso_energy", "hmc_energy"):
        want = wt.sampler.generic_nuts_transition(
            jax.random.PRNGKey(5), sj, jnp.asarray(h), jnp.asarray(dl),
            target=tj, kernel=KERNELS[kname](jkern), m=6)
        got = tw.sampler.generic_nuts_transition(
            tf.PRNGKey(5), st, torch.from_numpy(h), torch.from_numpy(dl),
            target=tt, kernel=KERNELS[kname](tkern), m=6)
        back = tiso.mcstate_to_numpy(got[0])
        for f in tiso.MCState._fields:
            _same(getattr(want[0], f), back[f], f"{kname}.{f}")
        _same(want[1], got[1], f"{kname} diag")


def test_entries_default_to_the_card(monkeypatch):
    """The new entries run on ``device="cuda"`` unless told otherwise:
    without a card (as here, or made so) the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q0 = np.zeros((2, 3))
    t = tw.targets.std_gauss(3)
    h = np.full(2, 0.3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.sampler.run_generic_nuts(0, q0, target=t,
                                    kernel=tw.sampler.IsokineticKernel(),
                                    h_macro=0.3, delta=0.1, num_iter=1, m=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.sampler.run_multinomial(0, q0, target=t, num_iter=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.sampler.run_walnuts_streaming(0, q0, h, h, target=t,
                                         cfg=tw.WalnutsConfig(m=2),
                                         num_iter=1)
