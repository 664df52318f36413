"""The slice as a whole, on the CPU: funnel(11) through the port's
public entry, pooled in-loop warmup then ``min_per_chain`` sampling
with the benchmark's ``(omega, sum x^2)`` summary, held against the JAX
engine on the same inputs and against the exact omega ~ N(0, 3^2)
marginal."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.sampler.megakernel import run_walnuts_fused as jax_fused

torch.set_num_threads(2)

C, D, M, WARMUP, N = 32, 11, 5, 20, 50


def _seed(key):
    """The JAX engine's hash seed derivation (megakernel.py:1258-1259)."""
    return int(jax.random.randint(jax.random.fold_in(key, 777), (1,), 0,
                                  2 ** 30, jnp.int32)[0])


def test_funnel_slice_matches_jax_and_marginal():
    q0 = 0.1 * np.random.default_rng(0).normal(size=(C, D))
    k_wu, k_draw = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    wu_kw = dict(num_iter=WARMUP, ring_rows=4, micro_unroll=4)
    draw_kw = dict(num_iter=N, stop_mode="min_per_chain", micro_unroll=4,
                   diag_rows=4)

    j_wu = jax_fused(
        k_wu, jnp.asarray(q0), jnp.full((C,), 0.3), jnp.full((C,), 0.3),
        target=wt.targets.funnel(D), cfg=wt.WalnutsConfig(m=M),
        warmup=wt.WarmupConfig(warmup_iter=WARMUP, pooled=True), rng="hash",
        **wu_kw)
    j_gen = wt.targets.funnel(D, generated=lambda x: jnp.stack(
        [x[..., 0], jnp.sum(x[..., 1:] ** 2, axis=-1)], axis=-1))
    j_out = jax_fused(k_draw, j_wu[2], j_wu[5], j_wu[6], target=j_gen,
                      cfg=wt.WalnutsConfig(m=M), rng="hash", **draw_kw)

    t_wu = tw.run_walnuts_fused(
        _seed(k_wu), torch.from_numpy(q0), 0.3, 0.3,
        target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=M),
        warmup=tw.WarmupConfig(warmup_iter=WARMUP, pooled=True), **wu_kw)
    t_out = tw.run_walnuts_fused(
        _seed(k_draw), t_wu[2], t_wu[5], t_wu[6],
        target=tw.targets.funnel(D, generated=tw.targets.omega_sumsq),
        cfg=tw.WalnutsConfig(m=M), **draw_kw)

    # one pooled (H, delta), moved by warmup, as JAX moved it
    h, delta = t_wu[5].numpy(), t_wu[6].numpy()
    assert np.ptp(h) == 0 and np.ptp(delta) == 0 and h[0] != 0.3
    np.testing.assert_allclose(h, np.asarray(j_wu[5]), rtol=1e-9)
    np.testing.assert_allclose(delta, np.asarray(j_wu[6]), rtol=1e-9)
    # the same transitions: equal counts and gradient evaluations, draws
    # to rounding grown over ~3000 rounds (5e-9 measured)
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3]))
    assert t_out[4] == int(j_out[4])
    samples = t_out[0].numpy()
    assert samples.shape == (N, C, 2) and np.isfinite(samples).all()
    np.testing.assert_allclose(samples, np.asarray(j_out[0]), rtol=1e-6,
                               atol=1e-9)
    # omega ~ N(0, 3^2) (the check of tests/test_megakernel.py:39-52)
    w = samples[..., 0].ravel()
    n_eff = len(w) / 50
    assert abs(w.mean()) < 5 * 3 / np.sqrt(n_eff), w.mean()
    assert abs(w.std() - 3.0) < 5 * 3 * np.sqrt(0.5 / n_eff), w.std()
