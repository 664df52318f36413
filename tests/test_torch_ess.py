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
