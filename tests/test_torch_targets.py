"""The port's targets against the JAX package's, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw

torch.set_num_threads(2)

CASES = {
    "funnel7": (lambda m: m.targets.funnel(7), 7),
    "funnel101": (lambda m: m.targets.funnel(101), 101),
    "funnel11_scale2": (lambda m: m.targets.funnel(11, scale=2.0), 11),
    "std_gauss9": (lambda m: m.targets.std_gauss(9), 9),
    "corr_gauss095": (lambda m: m.targets.corr_gauss(0.95), 2),
    "smile": (lambda m: m.targets.smile(), 2),
    "rosenbrock": (lambda m: m.targets.rosenbrock(), 2),
    "mod_funnel": (lambda m: m.targets.mod_funnel(), 2),
    "funnel_rescaled7": (lambda m: m.targets.funnel_rescaled(7), 7),
    "ill_gauss9": (lambda m: m.targets.ill_conditioned_gauss(9), 9),
    "ill_gauss4_k100": (
        lambda m: m.targets.ill_conditioned_gauss(4, 100.0), 4),
}


def _q(D, C=32, seed=0):
    return np.random.default_rng(seed).normal(size=(C, D)) * 0.8


@pytest.mark.parametrize("name", list(CASES))
def test_logp_grad_matches_jax(name):
    make, D = CASES[name]
    q = _q(D)
    lp_j, g_j = make(wt).logp_grad(jnp.asarray(q))
    lp_t, g_t = make(tw).logp_grad(torch.from_numpy(q))
    assert lp_t.dtype == torch.float64 and g_t.shape == (32, D)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-300)


@pytest.mark.parametrize("name", ["funnel7", "std_gauss9", "corr_gauss095",
                                  "mod_funnel", "funnel_rescaled7",
                                  "ill_gauss9"])
def test_scalar_logp_matches_jax(name):
    make, D = CASES[name]
    q = _q(D, C=5, seed=1)
    lp_j = make(wt).logp(jnp.asarray(q))
    lp_t = make(tw).logp(torch.from_numpy(q))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12)


@pytest.mark.parametrize("name", ["funnel7", "std_gauss9"])
def test_autograd_fallback_matches_analytic(name):
    """A target given only its scalar log density gets the gradient of
    the batch's summed log density from autograd."""
    make, D = CASES[name]
    analytic = make(tw)
    plain = tw.Target(analytic._logp, D)
    q = torch.from_numpy(_q(D, C=6, seed=2))
    lp_a, g_a = analytic.logp_grad(q)
    lp_p, g_p = plain.logp_grad(q)
    assert not lp_p.requires_grad and not g_p.requires_grad
    torch.testing.assert_close(lp_p, lp_a, rtol=1e-12, atol=0)
    torch.testing.assert_close(g_p, g_a, rtol=1e-12, atol=1e-300)


def test_generated_summary_matches_bench_lambda():
    """``omega_sumsq`` is the benchmark's ``(omega, sum x^2)`` summary."""
    q = _q(11, C=8, seed=3)
    t_j = wt.targets.funnel(11, generated=lambda x: jnp.stack(
        [x[..., 0], jnp.sum(x[..., 1:] ** 2, axis=-1)], axis=-1))
    t_t = tw.targets.funnel(11, generated=tw.targets.omega_sumsq)
    assert t_t.generated_dim == t_j.generated_dim == 2
    assert tw.targets.funnel(11).generated_dim == 11
    np.testing.assert_allclose(
        t_t.generated(torch.from_numpy(q)).numpy(),
        np.asarray(t_j.generated(jnp.asarray(q))), rtol=1e-12)


def test_kernel_ids():
    assert tw.targets.funnel(5, scale=2.5).kernel_id == "funnel"
    assert tw.targets.funnel(5, scale=2.5).kernel_param == 2.5
    assert tw.targets.std_gauss(5).kernel_id == "std_gauss"
    assert tw.Target(lambda q: -q.sum(), 3).kernel_id is None
