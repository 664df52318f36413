"""The JAX package's long statistical acceptance tests, run by the port on
the card: ``tests/test_sampler.py``'s funnel omega marginal and
``tests/test_float32.py``'s float32 funnel tail (the scan engine), and
the tests whose runs cost too much on the CPU for the suite (the scan
engine's recovery from deep in the funnel's neck, generic NUTS on the
funnel, the isokinetic multinomial sampler, the implicit
midpoint end to end, the paper mode on the funnel).  Each runs at the JAX
test's sizes, seeds and gates, from the JAX test's starting points
(``PRNGKey(seed)`` through the port's threefry).

These cases need a CUDA device; without one they skip.  The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda -rP \\
        tests/test_torch_stats_gpu.py

Each gate prints its statistic and bound (``-rP`` shows them for the
tests that pass).  ``WALNUTS_STATS_DEVICE=cpu`` runs the same cases on
the CPU instead, for a host where the card is not at hand.
"""

import os

import numpy as np
import pytest
import torch
from scipy import stats

import walnuts_tpu_torch as tw
from torch_stats import normal, scan_run
from walnuts_tpu_torch import targets
from walnuts_tpu_torch.sampler import (HMCKernel, IsokineticKernel,
                                       MultinomialConfig, run_generic_nuts,
                                       run_multinomial, walnuts_pseudo)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if os.environ.get("WALNUTS_STATS_DEVICE") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np(x):
    return x.double().cpu().numpy()


def _gate(label, stat, bound):
    """Print ``|stat| < bound`` and assert it."""
    print(f"{label}: {stat:.6g} against {bound:.6g}", flush=True)
    assert abs(stat) < bound, (label, stat, bound)


def test_funnel_omega_marginal(dev):
    """funnel(11)'s first coordinate is exactly N(0, 3^2)
    (``tests/test_sampler.py:63-72``)."""
    samples, _, _ = scan_run(targets.funnel(11), C=128, num_iter=1500,
                             warm=500, m=8, h0=0.3, delta0=0.3, seed=3,
                             device=dev)
    w = samples[501:, :, 0].ravel()
    n_eff = len(w) / 40.0  # funnel mixes slowly in omega
    _gate("omega mean", w.mean(), 5 * 3.0 / np.sqrt(n_eff))
    _gate("omega sd - 3", w.std() - 3.0, 5 * 3.0 * np.sqrt(0.5 / n_eff))


def test_f32_funnel_tail_and_moments(dev):
    """The scan engine in float32: funnel(11)'s omega marginal is
    N(0, 9) with the left tail resolved (``tests/test_float32.py:20-41``)."""
    C = 256
    q0 = 0.1 * normal(0, (C, 11), torch.float32)
    samples, _, _ = tw.run_walnuts(
        1, q0, target=targets.funnel(11), cfg=tw.WalnutsConfig(m=8),
        warmup=tw.WarmupConfig(warmup_iter=300, pooled=True), num_iter=1200,
        h0=0.3, delta0=0.3, device=dev)
    assert samples.dtype == torch.float32
    w = _np(samples)[301:, :, 0].ravel()
    n_eff = len(w) / 60  # generous autocorrelation allowance
    se_mean = 3.0 / np.sqrt(n_eff)
    _gate("omega mean", w.mean(), 5 * se_mean)
    _gate("omega sd - 3", w.std() - 3.0, 5 * 3 * np.sqrt(0.5 / n_eff))
    tail = (w < -3.0).mean()
    p_exact = stats.norm.cdf(-1.0)
    se_tail = np.sqrt(p_exact * (1 - p_exact) / n_eff)
    _gate("P(omega < -3) - Phi(-1)", tail - p_exact, 5 * se_tail)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_f32_deep_neck_recovery(dev, dtype):
    """Transient from omega = -10: the step-halving search resolves the
    e^10 curvature and the chains leave the neck
    (``tests/test_float32.py:75-101``'s loop, one case per dtype)."""
    t = tw.targets.funnel(11)
    C = 64
    q0 = torch.zeros((C, 11), dtype=dtype)
    q0[:, 0] = -10.0
    q0 = q0 + 0.01 * normal(3, (C, 11), dtype)
    cfg = tw.WalnutsConfig(m=8, igr=tw.ops.IntegratorConfig(max_c=16))
    wu = tw.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    samples, diags, state = tw.run_walnuts(
        4, q0, target=t, cfg=cfg, warmup=wu, num_iter=60, h0=0.3,
        delta0=0.3, device=dev)
    assert samples.dtype == dtype
    w = _np(samples)[..., 0]
    assert np.all(np.isfinite(w)), dtype
    med_end = np.median(w[-10:])
    print(f"median omega over the last 10 iterations: {med_end:.6g} "
          f"against > -6", flush=True)
    assert med_end > -6.0, (dtype, med_end)




def test_generic_nuts_hmc_funnel_omega(dev):
    """iWALNUTS-style run on the funnel: omega ~ N(0, 9)
    (``tests/test_isokinetic.py:143-153``)."""
    q0 = 0.2 * normal(4, (64, 6))
    samples, _ = run_generic_nuts(
        5, q0, target=targets.funnel(6), kernel=HMCKernel(), h_macro=0.4,
        delta=0.3, num_iter=800, m=7, device=dev)
    w = _np(samples)[200:, :, 0].ravel()
    n_eff = len(w) / 50
    _gate("omega mean", w.mean(), 5 * 3 / np.sqrt(n_eff))
    _gate("omega sd - 3", w.std() - 3.0, 5 * 3 * np.sqrt(0.5 / n_eff))


def test_multinomial_isokinetic_corr_gauss(dev):
    """The reference's MCsim experiment config: corrGauss(0.95),
    isokinetic adaptive steps (``tests/test_multinomial.py:30-45``)."""
    q0 = 0.2 * normal(2, (64, 2))
    samples, _, _ = run_multinomial(
        3, q0, target=targets.corr_gauss(0.95), kernel=IsokineticKernel(),
        cfg=MultinomialConfig(l_orbit=32), h0=0.3, delta0=0.2, num_iter=600,
        warmup_iter=150, device=dev)
    s = _np(samples)[200:]
    n_eff = s.shape[0] * s.shape[1] / 60
    _gate("mean", s.mean(), 5 / np.sqrt(n_eff))
    _gate("sd - 1", s.std() - 1.0, 5 * np.sqrt(0.5 / n_eff))
    corr = np.corrcoef(s[..., 0].ravel(), s[..., 1].ravel())[0, 1]
    _gate("corr - 0.95", corr - 0.95, 0.05)


def test_im_sampler_end_to_end(dev):
    """WALNUTS with the implicit midpoint samples a Gaussian
    (``tests/test_implicit_and_rescaled.py:117-129``)."""
    q0 = 0.1 * normal(0, (32, 4))
    samples, _, _ = tw.run_walnuts(
        1, q0, target=targets.std_gauss(4),
        cfg=tw.WalnutsConfig(m=5, integrator="adapt_implicit_midpoint_d"),
        warmup=tw.WarmupConfig(warmup_iter=100), num_iter=300, h0=0.5,
        delta0=0.1, device=dev)
    s = _np(samples)[101:]
    n_eff = s.shape[0] * s.shape[1] / 8
    _gate("mean", s.mean(), 5 / np.sqrt(n_eff))
    _gate("sd - 1", s.std() - 1.0, 5 * np.sqrt(0.5 / n_eff))


def test_pseudo_funnel_omega(dev):
    """``tests/test_pseudocode.py:100-110``: omega ~ N(0, 9)."""
    q0 = torch.zeros((64, 6), dtype=torch.float64)
    q0[:, 0] += 0.5
    draws = walnuts_pseudo(
        9, q0, target=targets.funnel(6),
        inv_mass=torch.ones(6, dtype=torch.float64), macro_step=0.5,
        max_depth=9, max_error=0.2, iter_warmup=100, iter_sample=600,
        device=dev)
    w = _np(draws)[:, :, 0].ravel()
    n_eff = len(w) / 60
    _gate("omega mean", w.mean(), 5 * 3 / np.sqrt(n_eff))
    _gate("omega sd - 3", w.std() - 3.0, 5 * 3 * np.sqrt(0.5 / n_eff))
