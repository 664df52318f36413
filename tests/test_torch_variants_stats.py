"""The port's scan engine under pooled warmup, and its implicit-midpoint
and rescaled-leapfrog integrators, held to the JAX package's tests of
them: ``tests/test_flow_variants.py``'s pooled-warmup test and the seven
tests of ``tests/test_implicit_and_rescaled.py``, at their own sizes,
seeds and gates, on the CPU.  Starting points come from JAX's
``PRNGKey`` through the port's threefry; the first five iterations of the
pooled run are held to JAX's under ``ADAPTIVE``.
``test_im_sampler_end_to_end`` runs on the card
(``tests/test_torch_stats_gpu.py``): its fixed-point loop costs ~2,000 s
here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from torch_stats import (SCAN_INT_COLS, assert_prefix, normal,
                         split_normal_states)
from walnuts_tpu_torch import targets
from walnuts_tpu_torch.ops.hamiltonian import hamiltonian
from walnuts_tpu_torch.ops.integrators import (IntegratorConfig,
                                               adapt_implicit_midpoint_d,
                                               adapt_rescaled_leapfrog_d)
from walnuts_tpu_torch.ops.leapfrog import PhasePoint, implicit_midpoint_step
from walnuts_tpu_torch.utils import threefry
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT, assert_parity

torch.set_num_threads(2)


def _setup(t, C=8, seed=0):
    """``tests/test_implicit_and_rescaled.py``'s ``_setup``."""
    q, k2, lp, g = split_normal_states(t, C, seed)
    return q, threefry.normal(k2, (C, t.dim), torch.float64), g, lp


def _full(C, x):
    return torch.full((C,), x, dtype=torch.float64)


def _coin(C):
    """The coin the JAX integrators draw from ``PRNGKey(0)``."""
    return threefry.uniform(threefry.PRNGKey(0), (C,), torch.float64)


@functools.cache
def _pooled_run():
    q0 = 0.1 * normal(0, (32, 6))
    s, d, st = tw.run_walnuts(
        1, q0, target=targets.funnel(6), cfg=tw.WalnutsConfig(m=6),
        warmup=tw.WarmupConfig(warmup_iter=150, pooled=True), num_iter=400,
        h0=1.0, delta0=0.3, device="cpu")
    return s.numpy(), d.numpy(), st


def test_pooled_warmup_converges_and_is_uniform():
    """Pooled mode: all chains share one (H, delta) after warmup, and
    the sampler still produces correct moments."""
    samples, diags, state = _pooled_run()
    h = state.h.numpy()
    delta = state.delta.numpy()
    assert np.allclose(h, h[0]), h
    assert np.allclose(delta, delta[0]), delta
    w = samples[151:, :, 0].ravel()
    n_eff = len(w) / 50
    assert abs(w.mean()) < 5 * 3 / np.sqrt(n_eff), w.mean()
    assert abs(w.std() - 3.0) < 5 * 3 * np.sqrt(0.5 / n_eff), w.std()


def test_im_step_exact_on_gaussian_matches_cayley():
    """For a standard Gaussian, implicit midpoint is the Cayley
    transform: q2 = ((1 - h^2/4) q + h v) / (1 + h^2/4)."""
    t = targets.std_gauss(5)
    q, v, g, lp = _setup(t, C=4)
    new, err, ok, nev = implicit_midpoint_step(
        t, PhasePoint(q, v, g, lp), _full(4, 0.3), fp_tol=1e-14)
    a = 0.3**2 / 4.0
    q2 = ((1 - a) * q.numpy() + 0.3 * v.numpy()) / (1 + a)
    np.testing.assert_allclose(new.q.numpy(), q2, atol=1e-12)
    assert np.all(ok.numpy())


def test_im_step_energy_conservation_gaussian():
    """Implicit midpoint conserves the Gaussian Hamiltonian exactly (it
    is a symplectic Cayley rotation)."""
    t = targets.std_gauss(5)
    q, v, g, lp = _setup(t, C=4, seed=1)
    h0 = hamiltonian(lp, v)
    s = PhasePoint(q, v, g, lp)
    for _ in range(20):
        s, _, ok, _ = implicit_midpoint_step(t, s, _full(4, 0.25),
                                             fp_tol=1e-14)
    h_end = hamiltonian(s.lp, s.v)
    np.testing.assert_allclose(h_end.numpy(), h0.numpy(), atol=1e-9)


def test_im_reversibility():
    t = targets.funnel(5)
    q, v, g, lp = _setup(t, C=4, seed=2)
    h = _full(4, 0.05)
    s1, _, ok1, _ = implicit_midpoint_step(t, PhasePoint(q, v, g, lp), h,
                                           fp_tol=1e-14)
    s2, _, ok2, _ = implicit_midpoint_step(
        t, PhasePoint(s1.q, -s1.v, s1.g, s1.lp), h, fp_tol=1e-14)
    assert np.all(ok1.numpy() & ok2.numpy())
    np.testing.assert_allclose(s2.q.numpy(), q.numpy(), atol=1e-10)
    np.testing.assert_allclose(-s2.v.numpy(), v.numpy(), atol=1e-10)


def test_im_newton_matches_fixed_point():
    t = targets.funnel(4)
    q, v, g, lp = _setup(t, C=4, seed=3)
    s0 = PhasePoint(q, v, g, lp)
    h = _full(4, 0.1)
    s_fp, _, ok_fp, _ = implicit_midpoint_step(t, s0, h, fp_tol=1e-13)
    s_nw, _, ok_nw, _ = implicit_midpoint_step(t, s0, h, fp_tol=1e-13,
                                               newton=True)
    assert np.all(ok_fp.numpy() & ok_nw.numpy())
    np.testing.assert_allclose(s_fp.q.numpy(), s_nw.q.numpy(), atol=1e-9)


def test_adapt_im_integrator_protocol():
    t = targets.funnel(11)
    C = 16
    q, v, g, lp = _setup(t, C=C, seed=4)
    h0 = hamiltonian(lp, v)
    cfg = IntegratorConfig()
    res = adapt_implicit_midpoint_d(
        _coin(C), t, q, v, g, lp, h0, _full(C, 0.4), _full(C, 1.0),
        _full(C, 0.1), None, torch.ones(C, dtype=torch.bool), cfg)
    err = np.abs((res.h_end - h0).numpy())
    finite = np.isfinite(res.h_end.numpy())
    at_cap = res.i_f.numpy() == cfg.max_c
    assert np.all(~finite | (err < 0.1) | at_cap)
    lwt = res.lwt.numpy()
    i_f, i_b = res.i_f.numpy(), res.i_b.numpy()
    assert np.all(lwt[(i_f == i_b) & finite] == 0.0)


def test_rescaled_integrator_runs_and_weights():
    t = targets.mod_funnel()
    C = 16
    q, v, g, lp = _setup(t, C=C, seed=5)
    h0 = hamiltonian(lp, v)
    res = adapt_rescaled_leapfrog_d(
        _coin(C), t, q, v, g, lp, h0, _full(C, 0.3), _full(C, 1.0),
        _full(C, 0.3), None, torch.ones(C, dtype=torch.bool),
        IntegratorConfig())
    assert np.all(np.isfinite(res.q.numpy()))
    lwt = res.lwt.numpy()
    assert np.all((lwt == 0.0) | (lwt < -600.0))
    assert np.all(res.n_eval_f.numpy() >= 1)


def test_first_iterations_are_the_jax_tests_run():
    """JAX's first five iterations of the pooled-warmup run against the
    port's 400-iteration run, under ``ADAPTIVE``; the starting points
    within ``EXACT``."""
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (32, 6),
                                 jnp.float64)
    assert_parity(np.asarray(q0), 0.1 * normal(0, (32, 6)).numpy(), EXACT,
                  "q0")
    s, d, _ = wt.run_walnuts(
        jax.random.PRNGKey(1), q0, target=wt.targets.funnel(6),
        cfg=wt.WalnutsConfig(m=6),
        warmup=wt.WarmupConfig(warmup_iter=150, pooled=True), num_iter=5,
        h0=1.0, delta0=0.3)
    samples, diags, _ = _pooled_run()
    assert_prefix((s, d), (samples, diags), ADAPTIVE, SCAN_INT_COLS,
                  "funnel(6) pooled")
