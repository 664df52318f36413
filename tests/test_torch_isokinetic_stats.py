"""The port's isokinetic line held to the posterior: generic-step NUTS
(``run_generic_nuts``) under the isokinetic and HMC kernels and their
flow-error variants, and the flow-error step protocols, at the sizes,
seeds and gates of ``tests/test_isokinetic.py`` and
``tests/test_flow_variants.py``, on the CPU.  Starting points come from
JAX's ``PRNGKey`` through the port's threefry; the first five iterations
of the isokinetic Gaussian run are held to JAX's under ``EXACT`` (fixed
tuning).  ``test_generic_nuts_hmc_funnel_omega`` runs on the card
(``tests/test_torch_stats_gpu.py``): it costs ~270 s here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
from torch_stats import assert_prefix, normal, split_normal_states
from walnuts_tpu_torch import targets
from walnuts_tpu_torch.ops.isokinetic import (MCState, adapt_mc_step_flow2,
                                              isokinetic_multistep_err,
                                              refresh_u)
from walnuts_tpu_torch.sampler import (HMCKernel, IsokineticKernel,
                                       run_generic_nuts)
from walnuts_tpu_torch.utils import threefry
from walnuts_tpu_torch.utils.parity import EXACT

torch.set_num_threads(2)

# generic NUTS' integer-valued diagnostic columns
GENERIC_INT_COLS = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)


def _state(t, C=8, seed=0):
    """``tests/test_flow_variants.py``'s ``_state``."""
    q, k2, lp, g = split_normal_states(t, C, seed)
    u = refresh_u(k2, q.shape, torch.float64)
    return MCState(q, u, g, lp)


def _gauss(kernel, seed, h_macro, C=64, num_iter=400, m=6, delta=0.2):
    q0 = 0.2 * normal(seed, (C, 4))
    s, d = run_generic_nuts(seed + 1, q0, target=targets.std_gauss(4),
                            kernel=kernel, h_macro=h_macro, delta=delta,
                            num_iter=num_iter, m=m, device="cpu")
    return s.numpy(), d.numpy()


@functools.cache
def _iso_gauss():
    return _gauss(IsokineticKernel(), 0, 0.4)


def test_generic_nuts_isokinetic_samples_gaussian():
    s = _iso_gauss()[0][100:]
    n_eff = s.shape[0] * s.shape[1] / 20
    assert abs(s.mean()) < 5 / np.sqrt(n_eff), s.mean()
    assert abs(s.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff), s.std()


def test_generic_nuts_hmc_samples_gaussian():
    s = _gauss(HMCKernel(), 2, 0.5)[0][100:]
    n_eff = s.shape[0] * s.shape[1] / 10
    assert abs(s.mean()) < 5 / np.sqrt(n_eff), s.mean()
    assert abs(s.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff), s.std()


def test_err_est_decreases_with_refinement():
    """The Euler-comparison flow-error estimate shrinks as the micro
    steps shrink (it drives the halving search)."""
    t = targets.corr_gauss(0.95)
    s = _state(t, C=8)
    errs = []
    for c in [0, 1, 2, 3]:
        n = 2**c
        r, err = isokinetic_multistep_err(
            t, s, torch.full((8,), 0.4 / n, dtype=torch.float64),
            torch.full((8,), n, dtype=torch.int32))
        errs.append(err.numpy())
    errs = np.stack(errs)
    assert np.all(errs[3] < errs[0]), errs


def test_flow2_step_protocol():
    t = targets.funnel(6)
    s = _state(t, C=16, seed=2)
    out, lwt, stats = adapt_mc_step_flow2(
        threefry.PRNGKey(0), t, s,
        torch.full((16,), 0.3, dtype=torch.float64),
        torch.full((16,), 0.2, dtype=torch.float64),
        torch.ones(16, dtype=torch.bool))
    i_f, i_b = stats.i_f.numpy(), stats.i_b.numpy()
    lwt = lwt.numpy()
    assert np.all(lwt[i_b < i_f] < -600)
    assert np.all(np.isfinite(out.q.numpy()))


@pytest.mark.parametrize("kernel,label", [
    (IsokineticKernel(variant="flow"), "iso_flow"),
    (IsokineticKernel(variant="flow2"), "iso_flow2"),
    (HMCKernel(variant="flow"), "hmc_flow"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_flow_variant_samples_gaussian(kernel, label):
    x = _gauss(kernel, 0, 0.4, C=32, num_iter=300, m=5, delta=0.1)[0][80:]
    n_eff = x.shape[0] * x.shape[1] / 15
    assert abs(x.mean()) < 5 / np.sqrt(n_eff), (label, x.mean())
    assert abs(x.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff), (label, x.std())


def test_first_iterations_are_the_jax_tests_run():
    """JAX's first five iterations of the isokinetic Gaussian run against
    the port's 400-iteration run, under ``EXACT``."""
    from walnuts_tpu.sampler import IsokineticKernel as JaxIso
    from walnuts_tpu.sampler import run_generic_nuts as jax_generic_nuts

    q0 = 0.2 * jax.random.normal(jax.random.PRNGKey(0), (64, 4),
                                 jnp.float64)
    s, d = jax_generic_nuts(
        jax.random.PRNGKey(1), q0, target=wt.targets.std_gauss(4),
        kernel=JaxIso(), h_macro=0.4, delta=0.2, num_iter=5, m=6)
    assert_prefix((s, d), _iso_gauss(), EXACT, GENERIC_INT_COLS,
                  "isokinetic std_gauss(4)")
