"""The port's fixed-orbit multinomial sampler (``run_multinomial``) held
to the posterior and to its warmup: ``tests/test_multinomial.py``'s
statistical tests at their own sizes, seeds and gates, on the CPU.
Starting points come from JAX's ``PRNGKey`` through the port's threefry;
the first five iterations of the HMC Gaussian run (in warmup) are held to
JAX's under ``ADAPTIVE``.  ``test_multinomial_isokinetic_corr_gauss``
runs on the card (``tests/test_torch_stats_gpu.py``): it costs ~140 s
here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import walnuts_tpu as wt
from torch_stats import assert_prefix, normal
from walnuts_tpu_torch import targets
from walnuts_tpu_torch.sampler import (HMCKernel, MultinomialConfig,
                                       run_multinomial)
from walnuts_tpu_torch.utils.parity import ADAPTIVE

torch.set_num_threads(2)

# the multinomial sampler's integer-valued diagnostic columns
MULTI_INT_COLS = (1, 2, 3, 4, 6, 9)


def _run(t, seed, q_scale, C, **kw):
    q0 = q_scale * normal(seed, (C, t.dim))
    s, d, (h, delta) = run_multinomial(seed + 1, q0, target=t, device="cpu",
                                       **kw)
    return s.numpy(), d.numpy(), h.numpy(), delta.numpy()


@functools.cache
def _hmc_gauss():
    return _run(targets.std_gauss(4), 0, 0.2, 64, kernel=HMCKernel(),
                cfg=MultinomialConfig(l_orbit=16), h0=0.3, delta0=0.2,
                num_iter=500, warmup_iter=100)


def test_multinomial_hmc_gaussian_moments():
    s = _hmc_gauss()[0][150:]
    n_eff = s.shape[0] * s.shape[1] / 30
    assert abs(s.mean()) < 5 / np.sqrt(n_eff), s.mean()
    assert abs(s.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff), s.std()


def test_multinomial_warmup_adapts():
    _, _, h, delta = _run(targets.std_gauss(6), 4, 1.0, 32,
                          kernel=HMCKernel(),
                          cfg=MultinomialConfig(l_orbit=8), h0=5.0,
                          delta0=0.5, num_iter=120, warmup_iter=100)
    assert np.all(h < 5.0), h
    assert np.all(h > 1e-4), h
    assert np.all(np.isfinite(delta)), delta


def test_multinomial_wasps_off_runs():
    samples = _run(targets.std_gauss(3), 8, 1.0, 8, kernel=HMCKernel(),
                   cfg=MultinomialConfig(l_orbit=8, wasps=False), h0=0.4,
                   delta0=0.2, num_iter=30, warmup_iter=10)[0]
    assert np.all(np.isfinite(samples))


def test_first_iterations_are_the_jax_tests_run():
    """JAX's first five iterations of the HMC Gaussian run against the
    port's 500-iteration run, under ``ADAPTIVE``: its warmup adapts the
    step size by dual averaging from iteration 1."""
    from walnuts_tpu.sampler import HMCKernel as JaxHMC
    from walnuts_tpu.sampler import MultinomialConfig as JaxCfg
    from walnuts_tpu.sampler import run_multinomial as jax_multinomial

    q0 = 0.2 * jax.random.normal(jax.random.PRNGKey(0), (64, 4),
                                 jnp.float64)
    s, d, _ = jax_multinomial(
        jax.random.PRNGKey(1), q0, target=wt.targets.std_gauss(4),
        kernel=JaxHMC(), cfg=JaxCfg(l_orbit=16), h0=0.3, delta0=0.2,
        num_iter=5, warmup_iter=100)
    assert_prefix((s, d), _hmc_gauss()[:2], ADAPTIVE, MULTI_INT_COLS,
                  "multinomial HMC std_gauss(4)")
