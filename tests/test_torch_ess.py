"""The port's ESS and Rhat against the JAX package's, in float64."""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export the function ess under its module's name
jess = import_module("walnuts_tpu.diagnostics.ess")
tess = import_module("walnuts_tpu_torch.diagnostics.ess")

torch.set_num_threads(2)


def _ar1(shape, rho, seed):
    """AR(1) draws with per-chain offsets (ESS well below N*C)."""
    rng = np.random.default_rng(seed)
    x = np.empty(shape)
    x[0] = rng.normal(size=shape[1:])
    for i in range(1, shape[0]):
        x[i] = rho * x[i - 1] + rng.normal(size=shape[1:])
    return x + 0.1 * rng.normal(size=(1,) + shape[1:])


@pytest.mark.parametrize("shape, rho", [((257, 6), 0.7), ((200, 4, 3), 0.9),
                                        ((120, 1), 0.3)])
def test_ess_matches_jax(shape, rho):
    x = _ar1(shape, rho, seed=len(shape))
    got = tess.ess(torch.from_numpy(x))
    want = np.asarray(jax.jit(jess.ess)(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("fn", ["rhat", "split_rhat"])
def test_rhat_matches_jax(fn):
    x = _ar1((301, 5, 2), 0.8, seed=9)
    got = getattr(tess, fn)(torch.from_numpy(x))
    want = np.asarray(getattr(jess, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    got2 = getattr(tess, fn)(torch.from_numpy(x[..., 0]))
    want2 = np.asarray(getattr(jess, fn)(jnp.asarray(x[..., 0])))
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-10)


jstats = import_module("walnuts_tpu.diagnostics.stats")
tstats = import_module("walnuts_tpu_torch.diagnostics.stats")


@pytest.mark.parametrize("shape", [(120, 4), (90, 3, 2)])
def test_ess_per_grad_matches_jax(shape):
    x = _ar1(shape, 0.6, seed=3)
    grads = 123456.0
    want = np.asarray(jess.ess_per_grad(jnp.asarray(x), grads))
    got = tess.ess_per_grad(torch.from_numpy(x), grads)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_qq_normal_matches_jax():
    x = _ar1((80, 3), 0.5, seed=4)
    want = jstats.qq_normal(jnp.asarray(x))
    got = tstats.qq_normal(torch.from_numpy(x))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-14)


def test_index_stat_histogram_matches_jax():
    """Counts, edges and chi-square of |column 23|, with zeros dropped
    and a value of exactly 1.0 in the last bin."""
    rng = np.random.default_rng(6)
    d = rng.uniform(-1.0, 1.0, size=(40, 8, 24))
    d[3, :4, 23] = 0.0
    d[5, 0, 23] = -1.0
    for bins in (20, 7):
        want = jstats.index_stat_histogram(jnp.asarray(d), bins)
        got = tstats.index_stat_histogram(torch.from_numpy(d), bins)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-15, atol=1e-16)
        np.testing.assert_allclose(float(got[2]), float(want[2]),
                                   rtol=1e-12)


# ---- odd shapes, constant chains and float32 --------------------------

ODD_SHAPES = [(3, 1), (7, 5), (33, 2, 3), (2, 9, 1)]
KINDS = ["ar1", "constant_chains", "constant", "float32"]


def _odd_draws(shape, kind):
    """AR(1) draws, chains each held at its own value, every draw one
    value, or AR(1) draws in float32.  The constant chains hold
    multiples of 1/4, so a chain's mean is its value in any summation
    order (see the test below for values whose mean rounds)."""
    x = _ar1(shape, 0.5, seed=sum(shape))
    if kind == "constant_chains":
        level = 0.25 * np.arange(shape[1]) - 0.5
        x = np.broadcast_to(level.reshape((1, -1) + (1,) * (len(shape) - 2)),
                            shape).copy()
    elif kind == "constant":
        x = np.full(shape, 0.75)
    elif kind == "float32":
        x = x.astype(np.float32)
    return x


def _agree(got, want, dtype):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == np.float32 else dict(
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, want, equal_nan=True, **tol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=str)
@pytest.mark.parametrize("fn", ["ess", "rhat", "split_rhat", "ess_per_grad"])
def test_diagnostics_over_odd_shapes_match_jax(fn, shape, kind):
    """Each diagnostic on the same numpy input through JAX's function and
    the port's: shapes with one chain, one parameter, two draws or odd
    lengths; chains each constant (within-chain variance 0); every draw
    one value (0 / 0: NaN on both sides); float32 input."""
    x = _odd_draws(shape, kind)
    if fn == "ess_per_grad":
        want = jess.ess_per_grad(jnp.asarray(x), 4567.0)
        got = tess.ess_per_grad(torch.from_numpy(x), 4567.0)
    else:
        want = getattr(jess, fn)(jnp.asarray(x))
        got = getattr(tess, fn)(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    _agree(got, np.asarray(want), x.dtype)


@pytest.mark.parametrize("kind", ["ar1", "constant", "float32"])
@pytest.mark.parametrize("shape,n,prob", [
    ((1, 1), 1, 0.5), ((3, 7), 7, 0.9), ((5, 6), 4, 0.25),
    ((4, 5), 1, 0.37), ((2, 9), 9, 1.0), ((6, 3), 2, 0.0)], ids=str)
def test_masked_quantile_over_odd_shapes_matches_jax(shape, n, prob, kind):
    """``masked_quantile`` on rows filled to ``n`` of ``W`` columns (the
    rest garbage that must not count), at the interval's ends and
    inside it."""
    from walnuts_tpu.sampler.driver import masked_quantile as jax_quantile
    from walnuts_tpu_torch.sampler import masked_quantile

    x = np.random.default_rng(n).normal(size=shape)
    if kind == "constant":
        x[:, :n] = -1.25
    if kind == "float32":
        x = x.astype(np.float32)
    x[:, n:] = 1e6
    want = jax_quantile(jnp.asarray(x), jnp.asarray(n, jnp.int32), prob)
    got = masked_quantile(torch.from_numpy(x), n, prob)
    assert got.dtype == torch.from_numpy(x).dtype
    _agree(got, np.asarray(want), x.dtype)


def test_rhat_of_chains_whose_mean_rounds():
    """Chains each held at a value whose mean over the draws rounds:
    JAX's two-pass variance (``x - mean`` squared) leaves a within-chain
    variance of ~1e-32 and a finite Rhat past 1e12, torch's variance is 0
    and the port's Rhat infinite.  Both say the chains have not mixed."""
    x = np.broadcast_to(_ar1((7, 5), 0.5, seed=12)[:1], (7, 5)).copy()
    want = float(jess.rhat(jnp.asarray(x)))
    got = float(tess.rhat(torch.from_numpy(x)))
    assert want > 1e12 and got == np.inf, (want, got)
