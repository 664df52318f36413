"""Shared pieces of the port's statistical acceptance tests
(``tests/test_torch_*_stats.py`` on the CPU, ``tests/test_torch_stats_gpu.py``
on the card).  Each of those tests is a JAX test of ``tests/`` run through
``walnuts_tpu_torch`` at the JAX test's sizes, seeds and gates: its
starting points come from the same ``PRNGKey`` through the port's threefry
stream, and its runs take the same seeds, so they use JAX's draw stream.

This module imports no JAX.  :func:`assert_prefix` takes JAX's arrays as
numpy arrays; the CPU files make them."""

import numpy as np
import torch

import walnuts_tpu_torch as tw
from walnuts_tpu_torch.utils import threefry
from walnuts_tpu_torch.utils.parity import (ENERGY_RANGE, ENERGY_RANGE_COL,
                                            EXACT, assert_parity)

# the scan engine's integer-valued diagnostic columns (selected index,
# doublings, orbit extents, gradient counts, If range, passive flags, stop
# code, depth, refinement range)
SCAN_INT_COLS = (0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22)


def normal(seed, shape, dtype=torch.float64, device="cpu"):
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)``."""
    return threefry.normal(threefry.PRNGKey(seed, device), tuple(shape),
                           dtype)


def scan_run(t, C=64, num_iter=600, warm=200, m=6, h0=0.5, delta0=0.1,
             integrator="adapt_leapfrog_r2p", seed=0, device="cpu"):
    """``tests/test_sampler.py``'s ``_run`` through the port: ``q0 = 0.1
    normal(PRNGKey(seed))``, the run keyed by ``seed + 1``; returns
    ``(samples, diagnostics)`` as numpy arrays and the sampler state."""
    q0 = 0.1 * normal(seed, (C, t.dim))
    s, d, st = tw.run_walnuts(
        seed + 1, q0, target=t,
        cfg=tw.WalnutsConfig(m=m, integrator=integrator),
        warmup=tw.WarmupConfig(warmup_iter=warm), num_iter=num_iter,
        h0=h0, delta0=delta0, device=device)
    return s.cpu().numpy(), d.cpu().numpy(), st


def split_normal_states(target, C, seed):
    """The JAX tests' ``_state``/``_setup`` draws: ``k1, k2 =
    split(PRNGKey(seed))`` and ``q = normal(k1, (C, D))``; returns ``(q,
    k2, lp, g)``."""
    k1, k2 = threefry.split(threefry.PRNGKey(seed)).unbind(0)
    q = threefry.normal(k1, (C, target.dim), torch.float64)
    lp, g = target.logp_grad(q)
    return q, k2, lp, g


def moment_check(s, mean, var, n_eff_guess):
    """``tests/test_sampler.py``'s ``_moment_check``: the per-coordinate
    sample moments over draws and chains within 5 Monte Carlo standard
    errors."""
    se_mean = np.sqrt(var / n_eff_guess)
    se_var = var * np.sqrt(2.0 / n_eff_guess)
    assert np.all(np.abs(s.mean(axis=(0, 1)) - mean) < 5 * se_mean), (
        s.mean(axis=(0, 1)), mean, se_mean)
    assert np.all(np.abs(s.var(axis=(0, 1)) - var) < 5 * se_var), (
        s.var(axis=(0, 1)), var, se_var)


def _same(want, got, contract, label):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (label, want.shape, got.shape)
    if want.dtype.kind == "f":
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=label)
        np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=label)
        want, got = want[fin], got[fin]
    assert_parity(want, got, contract, label)


def assert_prefix(want, got, contract, int_cols=(), label=""):
    """The first rows of a long port run against JAX's run of only those
    rows: ``want`` and ``got`` are matching tuples of arrays (samples,
    diagnostics, ...), ``got``'s each at least as long on its leading
    axis.  Diagnostics (3-D arrays with ``int_cols``) keep those columns
    equal; every float is held to ``contract``, non-finite entries at the
    same places.  Under a contract other than ``EXACT`` the scan engine's
    column 17 (an energy difference) is held to ``ENERGY_RANGE``."""
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        g = np.asarray(g)[:w.shape[0]]
        name = f"{label}[{i}]"
        if w.ndim == 3 and int_cols and w.shape[-1] > max(int_cols):
            ints = list(int_cols)
            np.testing.assert_array_equal(g[..., ints], w[..., ints],
                                          err_msg=name)
            cols = [c for c in range(w.shape[-1]) if c not in int_cols]
            if contract is not EXACT and w.shape[-1] == 24:
                cols.remove(ENERGY_RANGE_COL)
                _same(w[..., ENERGY_RANGE_COL], g[..., ENERGY_RANGE_COL],
                      ENERGY_RANGE, name + " energy range")
            w, g = w[..., cols], g[..., cols]
        _same(w, g, contract, name)
