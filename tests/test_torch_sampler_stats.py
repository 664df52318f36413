"""The port's scan engine held to ``tests/test_sampler.py``'s statistical
tests of the orbit and the warmup (the index statistic's shape, warmup
adapting H and delta from H = 5, independent chains) and to
``tests/test_float32.py``'s float32 energy-accumulation check, at the JAX
tests' sizes, seeds and gates, on the CPU.  Starting points come from
JAX's ``PRNGKey`` through the port's threefry; the first five iterations
of the index-statistic run are held to JAX's under ``ADAPTIVE``.
``test_f32_deep_neck_recovery`` runs on the card
(``tests/test_torch_stats_gpu.py``): its halving search to ``max_c = 16``
costs ~150 s per dtype here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from torch_stats import SCAN_INT_COLS, assert_prefix, normal, scan_run
from walnuts_tpu_torch.ops.hamiltonian import hamiltonian
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT, assert_parity

torch.set_num_threads(2)


@functools.cache
def _index_run():
    return scan_run(tw.targets.std_gauss(10), C=64, num_iter=400, warm=200,
                    seed=5)


def test_index_statistic_distribution():
    """The |col 23| index statistic rises from ~0 near the origin,
    concentrates in the upper half and has a spike at 1
    (``MCMCutils.py:28-40``)."""
    samples, diags, state = _index_run()
    x = np.abs(diags[200:, :, 23].ravel())
    x = x[x > 0]  # drop unmoved iterations
    assert np.all(x <= 1.0 + 1e-9)
    hist, _ = np.histogram(x, bins=10, range=(0, 1))
    frac = hist / len(x)
    assert frac[0] < 0.02, frac          # near-empty first bin
    assert frac[5:].sum() > 0.45, frac   # upper-half concentration
    assert frac.max() < 0.35, frac       # no single dominating bin


def test_warmup_adapts_h_and_delta():
    samples, diags, state = scan_run(tw.targets.funnel(11), C=32,
                                     num_iter=300, warm=250, h0=5.0,
                                     delta0=0.9, seed=6)
    h = state.h.numpy()
    delta = state.delta.numpy()
    # started at absurd H=5.0: adaptation must have pulled it down
    assert np.all(h < 5.0), h
    assert np.all(h > 1e-3), h
    assert np.all(delta > 0), delta
    assert np.all(np.isfinite(delta)), delta


def test_chains_are_independent():
    """Cross-chain correlation of the draws is ~0."""
    samples, _, _ = scan_run(tw.targets.std_gauss(2), C=16, num_iter=300,
                             warm=100, seed=12)
    s = samples[101:, :, 0]
    corr = np.corrcoef(s.T)
    off = corr[~np.eye(16, dtype=bool)]
    assert np.all(np.abs(off) < 0.35), np.abs(off).max()


def test_f32_energy_accumulation_micro():
    """A 2^10-micro-step macro step at moderate funnel depth accumulates
    the same |dH| in float32 as in float64, to 2e-3 absolute."""
    t = tw.targets.funnel(11)
    C = 16
    q64 = normal(9, (C, 11))
    q64[:, 0] = q64[:, 0] * 2.0
    v64 = normal(10, (C, 11))

    def run(q, v, n, h):
        lp, g = t.logp_grad(q)
        h0 = hamiltonian(lp, v)
        worst = torch.zeros_like(h0)
        for _ in range(n):
            vh = v + 0.5 * h * g
            q = q + h * vh
            lp, g = t.logp_grad(q)
            v = vh + 0.5 * h * g
            worst = torch.maximum(worst, torch.abs(hamiltonian(lp, v) - h0))
        return worst.double().numpy()

    h = 0.3 / 1024
    dh64 = run(q64, v64, 1024, h)
    dh32 = run(q64.float(), v64.float(), 1024, np.float32(h).item())
    assert np.all(np.abs(dh32 - dh64) < 2e-3), np.abs(dh32 - dh64).max()


def test_first_iterations_are_the_jax_tests_run():
    """JAX's first five iterations of ``test_index_statistic_distribution``'s
    run (std_gauss(10), warmup from iteration 1) against the port's
    400-iteration run, under ``ADAPTIVE``; the starting points within
    ``EXACT``."""
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(5), (64, 10),
                                 jnp.float64)
    assert_parity(np.asarray(q0), 0.1 * normal(5, (64, 10)).numpy(), EXACT,
                  "q0")
    s, d, st = wt.run_walnuts(
        jax.random.PRNGKey(6), q0, target=wt.targets.std_gauss(10),
        cfg=wt.WalnutsConfig(m=6), warmup=wt.WarmupConfig(warmup_iter=200),
        num_iter=5, h0=0.5, delta0=0.1)
    samples, diags, _ = _index_run()
    assert_prefix((s, d), (samples, diags), ADAPTIVE, SCAN_INT_COLS,
                  "std_gauss(10) index statistic")
