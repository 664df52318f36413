"""The port's streaming engine (``run_walnuts_streaming``) held to the
posterior and to the scan engine's orbit geometry:
``tests/test_streaming.py``'s statistical tests at their own sizes, seeds
and gates, on the CPU.  Starting points come from JAX's ``PRNGKey``
through the port's threefry; the first five iterations of the moments
run are held to JAX's under ``EXACT`` (fixed tuning)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from torch_stats import SCAN_INT_COLS, assert_prefix, normal
from walnuts_tpu.sampler.streaming import \
    run_walnuts_streaming as jax_streaming
from walnuts_tpu_torch.sampler import run_walnuts_streaming
from walnuts_tpu_torch.utils.parity import EXACT

torch.set_num_threads(2)


def _tuning(C):
    return (torch.full((C,), 0.5, dtype=torch.float64),
            torch.full((C,), 0.1, dtype=torch.float64))


@functools.cache
def _stream(C):
    q0 = normal(1, (C, 10))
    s, d, qf = run_walnuts_streaming(
        2, q0, *_tuning(C), target=tw.targets.std_gauss(10),
        cfg=tw.WalnutsConfig(m=6), num_iter=400, device="cpu")
    return s.numpy(), d.numpy(), qf.numpy()


def test_streaming_gauss_moments():
    s, diag, qf = _stream(64)
    x = s[100:]
    n_eff = x.shape[0] * x.shape[1] / 8
    assert abs(x.mean()) < 5 / np.sqrt(n_eff), x.mean()
    assert abs(x.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff), x.std()
    # final positions are the last recorded samples
    np.testing.assert_array_equal(qf, s[-1])


def test_streaming_matches_scan_distributions():
    """Orbit-geometry distributions (doubling depth, stop codes, If
    stats) agree with the synchronised scan engine."""
    C = 128
    _, d1, _ = _stream(C)
    wu = tw.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    _, d2, _ = tw.run_walnuts(
        2, normal(1, (C, 10)), target=tw.targets.std_gauss(10),
        cfg=tw.WalnutsConfig(m=6), warmup=wu, num_iter=400, h0=0.5,
        delta0=0.1, device="cpu")
    d2 = d2.numpy()
    for col in (1, 20, 19, 8, 9, 21, 22):
        gap = abs(d1[..., col].mean() - d2[..., col].mean())
        assert gap < 0.15, (col, gap)
    # index statistic histograms agree
    x1 = np.abs(d1[..., 23].ravel())
    x2 = np.abs(d2[..., 23].ravel())
    h1, _ = np.histogram(x1[x1 > 0], bins=10, range=(0, 1))
    h2, _ = np.histogram(x2[x2 > 0], bins=10, range=(0, 1))
    tvd = 0.5 * np.abs(h1 / h1.sum() - h2 / h2.sum()).sum()
    assert tvd < 0.08, tvd


def test_first_iterations_are_the_jax_tests_run():
    """JAX's first five streaming iterations of the moments run against
    the port's 400-iteration run, under ``EXACT``."""
    C = 64
    q0 = jax.random.normal(jax.random.PRNGKey(1), (C, 10), jnp.float64)
    s, d, _ = jax_streaming(
        jax.random.PRNGKey(2), q0, jnp.full((C,), 0.5, jnp.float64),
        jnp.full((C,), 0.1, jnp.float64), target=wt.targets.std_gauss(10),
        cfg=wt.WalnutsConfig(m=6), num_iter=5)
    samples, diags, _ = _stream(C)
    assert_prefix((s, d), (samples, diags), EXACT, SCAN_INT_COLS,
                  "streaming std_gauss(10)")
