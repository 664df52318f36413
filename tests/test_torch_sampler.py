"""Torch versions of the JAX-side sampler tests (``tests/test_sampler.py``)
that fit the CPU budget: the diagnostics contract, orbit statistics
(against JAX, and bounding the samples), determinism given a key, and
the diagonal inverse-mass metric against JAX.  The statistical moment
tests need long runs and are left for when the scan engine is fast."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT, assert_parity

torch.set_num_threads(2)


def _q0(c, d, seed=0):
    return 0.1 * np.random.default_rng(seed).normal(size=(c, d))


def test_diagnostics_contract():
    s, d, st = tw.run_walnuts(
        1, _q0(16, 5), target=tw.targets.std_gauss(5),
        cfg=tw.WalnutsConfig(m=6), warmup=tw.WarmupConfig(warmup_iter=20),
        num_iter=50, h0=0.5, delta0=0.1, device="cpu")
    d = d.numpy()
    assert d.shape == (50, 16, 24) and s.shape == (51, 16, 5)
    assert set(np.unique(d[..., 19])) <= {0.0, 4.0, -4.0, 5.0, 999.0}
    assert np.all(d[..., 15] > 0) and np.all(d[..., 18] > 0)
    assert np.all(d[..., 20] >= d[..., 1])
    assert np.all(d[..., 6] + d[..., 7] > 0)
    assert np.all(d[..., 17] >= 0)
    assert np.all(np.abs(d[..., 23]) <= 1.0 + 1e-9)
    assert st.iter_n == 50


def test_orbit_stats_match_jax_and_bound_samples():
    q0 = _q0(8, 11)
    kw = dict(num_iter=30, h0=0.3, delta0=0.3, collect_orbit_stats=True)
    want = wt.run_walnuts(
        jax.random.PRNGKey(1), jnp.asarray(q0), target=wt.targets.funnel(11),
        cfg=wt.WalnutsConfig(m=5, record_orbit_stats=True),
        warmup=wt.WarmupConfig(warmup_iter=10), **kw)
    got = tw.run_walnuts(
        1, q0, target=tw.targets.funnel(11),
        cfg=tw.WalnutsConfig(m=5, record_orbit_stats=True),
        warmup=tw.WarmupConfig(warmup_iter=10), device="cpu", **kw)
    s = got[0].numpy()[1:]
    omin, omax = got[3].numpy(), got[4].numpy()
    assert omin.shape == omax.shape == s.shape
    assert np.all(omin <= s + 1e-9) and np.all(omax >= s - 1e-9)
    for i, name in ((0, "samples"), (3, "orbit_min"), (4, "orbit_max")):
        assert_parity(np.asarray(want[i]), got[i].numpy(), ADAPTIVE, name)


def test_deterministic_given_key():
    kw = dict(target=tw.targets.std_gauss(4), cfg=tw.WalnutsConfig(m=4),
              warmup=tw.WarmupConfig(warmup_iter=5), num_iter=20,
              device="cpu")
    a = tw.run_walnuts(9, _q0(8, 4), **kw)[0]
    b = tw.run_walnuts(9, _q0(8, 4), **kw)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = tw.run_walnuts(10, _q0(8, 4), **kw)[0]
    assert not torch.equal(a, c)


def test_inverse_mass_metric_matches_jax():
    """``cfg.use_inv_mass`` with a diagonal inverse mass: the momentum
    draw is scaled and every energy and U-turn uses the metric."""
    q0 = _q0(16, 5, seed=2)
    inv_mass = np.array([1.0, 2.0, 0.5, 4.0, 0.25])
    kw = dict(num_iter=15, h0=0.3, delta0=0.2)
    want = wt.run_walnuts(
        jax.random.PRNGKey(6), jnp.asarray(q0), target=wt.targets.funnel(5),
        cfg=wt.WalnutsConfig(m=5, use_inv_mass=True),
        warmup=wt.WarmupConfig(warmup_iter=0),
        inv_mass=jnp.asarray(inv_mass), **kw)
    got = tw.run_walnuts(
        6, q0, target=tw.targets.funnel(5),
        cfg=tw.WalnutsConfig(m=5, use_inv_mass=True),
        warmup=tw.WarmupConfig(warmup_iter=0), inv_mass=inv_mass,
        device="cpu", **kw)
    assert_parity(np.asarray(want[0]), got[0].numpy(), EXACT, "samples")
    assert_parity(np.asarray(want[1]), got[1].numpy(), EXACT, "diagnostics")
