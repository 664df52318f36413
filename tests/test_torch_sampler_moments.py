"""The port's scan engine (``tw.run_walnuts``) held to the posterior:
``tests/test_sampler.py``'s moment tests at their own sizes, seeds and
gates (std_gauss(10) under the three integrators, corr_gauss(0.5)), on
the CPU.  The starting points are JAX's (``PRNGKey(seed)`` through the
port's threefry), the runs take JAX's seeds, and the first five
iterations of the R2P run are held to JAX's under ``ADAPTIVE``: the long
run is the JAX test's run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from torch_stats import (SCAN_INT_COLS, assert_prefix, moment_check, normal,
                         scan_run)
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT, assert_parity

torch.set_num_threads(2)


@functools.cache
def _std_gauss(integrator):
    h0 = 0.25 if integrator == "fixed_leapfrog" else 0.5
    return scan_run(tw.targets.std_gauss(10), C=64, num_iter=500, warm=200,
                    integrator=integrator, h0=h0)


@pytest.mark.parametrize("integrator", [
    "fixed_leapfrog", "adapt_leapfrog_d", "adapt_leapfrog_r2p",
])
def test_std_gauss_moments(integrator):
    samples, diags, state = _std_gauss(integrator)
    s = samples[201:]
    # crude effective size: iterations * chains / 4 (NUTS mixes fast here)
    moment_check(s, 0.0, 1.0, s.shape[0] * s.shape[1] / 8)


def test_corr_gauss_moments():
    samples, _, _ = scan_run(tw.targets.corr_gauss(0.5), C=64, num_iter=800,
                             warm=300, seed=2)
    s = samples[301:]
    moment_check(s, 0.0, 1.0, s.shape[0] * s.shape[1] / 8)
    corr = np.corrcoef(s[..., 0].ravel(), s[..., 1].ravel())[0, 1]
    assert abs(corr - 0.5) < 0.05, corr


def test_first_iterations_are_the_jax_tests_run():
    """JAX's first five iterations of the R2P run against the port's
    500-iteration run: the starting points within ``EXACT`` (threefry's
    normals are JAX's within a few ulp), then samples, diagnostics and
    tuning within ``ADAPTIVE`` (warmup adapts H and delta from
    iteration 1), integer diagnostics equal."""
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (64, 10),
                                 jnp.float64)
    assert_parity(np.asarray(q0), 0.1 * normal(0, (64, 10)).numpy(), EXACT,
                  "q0")
    s, d, st = wt.run_walnuts(
        jax.random.PRNGKey(1), q0, target=wt.targets.std_gauss(10),
        cfg=wt.WalnutsConfig(m=6, integrator="adapt_leapfrog_r2p"),
        warmup=wt.WarmupConfig(warmup_iter=200), num_iter=5, h0=0.5,
        delta0=0.1)
    samples, diags, _ = _std_gauss("adapt_leapfrog_r2p")
    assert_prefix((s, d), (samples, diags), ADAPTIVE, SCAN_INT_COLS,
                  "std_gauss(10) R2P")
    port5 = scan_run(tw.targets.std_gauss(10), C=64, num_iter=5, warm=200)[2]
    for f in ("h", "delta"):
        assert_parity(np.asarray(getattr(st, f)), getattr(port5, f).numpy(),
                      ADAPTIVE, f)
