"""The port's threefry stream (``walnuts_tpu_torch.utils.threefry``)
against ``jax.random`` with x64 on: keys, splits, fold-ins, random bits,
float32/float64 uniforms (with and without bounds) and Bernoulli draws
bit for bit; normal draws bit for bit on most elements and within a few
ulp on the rest (the ``erf_inv`` polynomial is XLA's, but XLA's CPU
``log1p`` differs from torch's in the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu_torch.utils import threefry as tf

SEEDS = [0, 1, 77, 2 ** 40 + 5, -3]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _words(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_and_bits_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    np.testing.assert_array_equal(tf.split(tk, 6).numpy(),
                                  _words(jax.random.split(jk, 6)))
    np.testing.assert_array_equal(tf.fold_in(tk, 12345).numpy(),
                                  _words(jax.random.fold_in(jk, 12345)))
    # batched: a vector of data into one key, one datum into many keys
    steps = np.arange(9)
    want = jax.vmap(lambda t: jax.random.fold_in(jk, t))(steps)
    np.testing.assert_array_equal(
        tf.fold_in(tk, torch.from_numpy(steps)).numpy(), _words(want))
    keys = jax.random.split(jk, 3)
    want = jax.vmap(lambda k: jax.random.split(jax.random.fold_in(k, 7), 6))(
        keys)
    np.testing.assert_array_equal(
        tf.split(tf.fold_in(tf.split(tk, 3), 7), 6).numpy(), _words(want))
    np.testing.assert_array_equal(
        tf.random_bits(tk, 32, (5, 7)).numpy(),
        np.asarray(jax.random.bits(jk, (5, 7), jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_uniform_and_bernoulli_bitwise(seed, jdt, tdt):
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    a = np.asarray(jax.random.uniform(jk, (1000,), jdt))
    b = tf.uniform(tk, (1000,), tdt).numpy()
    np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))
    # the transition's step-size jitter: bounds, with XLA's fused scaling
    a = np.asarray(jax.random.uniform(jk, (256, 2), jdt, 0.8, 1.2))
    b = tf.uniform(tk, (256, 2), tdt, 0.8, 1.2).numpy()
    np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))
    # batched keys: one pass equals per-key draws
    keys = jax.random.split(jk, 4)
    want = jax.vmap(lambda k: jax.random.uniform(k, (16,), jdt))(keys)
    got = tf.uniform(tf.split(tk, 4), (16,), tdt).numpy()
    np.testing.assert_array_equal(got.view(np.uint8),
                                  np.asarray(want).view(np.uint8))
    # bernoulli(k, 0.5, shape) draws in float64 (p is a Python float)
    np.testing.assert_array_equal(
        tf.bernoulli(tk, 0.5, (64, 10)).numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.5, (64, 10))))


@pytest.mark.parametrize("jdt,tdt,min_equal,max_ulp", [
    (jnp.float32, torch.float32, 0.98, 4),
    (jnp.float64, torch.float64, 0.9, 16)])
def test_normal_within_a_few_ulp(jdt, tdt, min_equal, max_ulp):
    """Bitwise on at least ``min_equal`` of the draws (measured: 99.0% in
    float32, 95.3% in float64); within ``max_ulp`` ulp of ``max(|value|,
    1)`` on all but one draw in 10^4 (measured: 2 ulp in float32, 15 in
    float64, i.e. 3.3e-15 absolute).  The exceptions sit where the
    float32 ``erf_inv`` switches polynomials (``w = 5``, |value| near
    2.94): a last-bit difference in ``log1p`` picks the other branch,
    and the two branches differ there by up to 7e-4 (one draw in 150000
    measured)."""
    for seed in SEEDS[:3]:
        jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
        a = np.asarray(jax.random.normal(jk, (50000,), jdt))
        b = tf.normal(tk, (50000,), tdt).numpy()
        assert np.mean(a == b) >= min_equal
        ulp = np.spacing(np.maximum(np.abs(a), 1.0).astype(a.dtype))
        assert np.mean(np.abs(a - b) <= max_ulp * ulp) >= 1.0 - 1e-4
        assert np.max(np.abs(a - b)) <= 1e-3


def test_erf_inv_edges():
    for dt in (torch.float32, torch.float64):
        x = torch.tensor([-1.0, 0.0, 1.0], dtype=dt)
        y = tf.erf_inv(x)
        assert y[0] == -torch.inf and y[1] == 0.0 and y[2] == torch.inf


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed):
    """``randint`` at its two call sites: the hash-seed derivation
    ``randint(fold_in(key, 777), (1,), 0, 2^30, int32)`` of the
    streaming and fused engines, and the multinomial sampler's forward
    split ``randint(key, (C,), 0, L)`` (int64 with x64 on); also int32
    spans and a batch of keys."""
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    a = jax.random.randint(jax.random.fold_in(jk, 777), (1,), 0, 2 ** 30,
                           jnp.int32)
    b = tf.randint(tf.fold_in(tk, 777), (1,), 0, 2 ** 30, torch.int32)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for L in (1, 7, 20, 1024):
        for shape in ((16,), (3, 5)):
            a = np.asarray(jax.random.randint(jk, shape, 0, L))
            b = tf.randint(tk, shape, 0, L).numpy()
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(b, a)
            a = np.asarray(jax.random.randint(jk, shape, 0, L, jnp.int32))
            b = tf.randint(tk, shape, 0, L, torch.int32).numpy()
            assert b.dtype == np.int32
            np.testing.assert_array_equal(b, a)
    keys = jax.random.split(jk, 4)
    want = jax.vmap(lambda k: jax.random.randint(k, (8,), 3, 23))(keys)
    np.testing.assert_array_equal(
        tf.randint(tf.split(tk, 4), (8,), 3, 23).numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tf.randint(tk, (2,), 5, 5)
