"""The port's paper-pseudocode mode (``walnuts_pseudo``) held to the
posterior: ``tests/test_pseudocode.py``'s statistical tests at their own
sizes, seeds and gates, on the CPU (``device="cpu"``: the entry runs on
the card unless asked otherwise).  The first five draws of the standard
normal run are held to JAX's under ``EXACT`` (the mode does not adapt).
``test_pseudo_funnel_omega`` runs on the card
(``tests/test_torch_stats_gpu.py``): it costs ~500 s here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from walnuts_tpu import targets as jax_targets
from walnuts_tpu.sampler.pseudocode import walnuts_pseudo as jax_pseudo
from walnuts_tpu_torch import targets
from walnuts_tpu_torch.examples.highdim_variants import logspace
from walnuts_tpu_torch.sampler import walnuts_pseudo
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

torch.set_num_threads(2)


@functools.cache
def _std_normal(iter_sample=500):
    draws = walnuts_pseudo(
        123, torch.zeros((32, 2), dtype=torch.float64),
        target=targets.std_gauss(2),
        inv_mass=torch.ones(2, dtype=torch.float64), macro_step=2.0,
        max_depth=10, max_error=0.1, iter_warmup=0, iter_sample=iter_sample,
        device="cpu")
    return draws.numpy()


def test_pseudo_std_normal_moments():
    """The reference smoke test config: 2-D standard normal,
    macro_step=2.0, max_error=0.1 (``test/test.py:9-37``)."""
    s = _std_normal()[50:]
    n_eff = s.shape[0] * s.shape[1] / 4
    assert abs(s.mean()) < 5 / np.sqrt(n_eff), s.mean()
    assert abs(s.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff), s.std()


def test_pseudo_with_mass_matrix():
    """A non-identity inverse mass on an ill-conditioned Gaussian: with
    ``inv_mass`` = the variances the sampler mixes as if isotropic."""
    var = logspace(0.0, 2.0, 4, torch.float64)  # jnp.logspace's bits
    draws = walnuts_pseudo(
        7, torch.zeros((32, 4), dtype=torch.float64),
        target=targets.ill_conditioned_gauss(4, 100.0), inv_mass=var,
        macro_step=1.5, max_depth=8, max_error=0.1, iter_warmup=50,
        iter_sample=400, device="cpu")
    s = draws.numpy()
    std = s.reshape(-1, 4).std(axis=0)
    n_eff = s.shape[0] * s.shape[1] / 6
    rel_err = np.abs(std / np.sqrt(var.numpy()) - 1.0)
    assert np.all(rel_err < 5 * np.sqrt(0.5 / n_eff)), (std, var)


def test_first_draws_are_the_jax_tests_run():
    """JAX's first five draws of the standard normal run against the
    port's 500-draw run, under ``EXACT``."""
    want = jax_pseudo(
        jax.random.PRNGKey(123), jnp.zeros((32, 2), jnp.float64),
        target=jax_targets.std_gauss(2), inv_mass=jnp.ones(2),
        macro_step=2.0, max_depth=10, max_error=0.1, iter_warmup=0,
        iter_sample=5)
    assert_parity(np.asarray(want), _std_normal()[:5], EXACT, "draws")
