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
