"""The port's counter-hash draws against the JAX engine's
``make_hash_draw``: uniforms and direction bits bitwise (top-24-bit
uniforms are exact), momenta within 4 ulp (``log``/``cos`` differ by
library)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.sampler import megakernel as jmk
from walnuts_tpu_torch.sampler import megakernel as tmk

torch.set_num_threads(2)

DTYPES = [(jnp.float64, torch.float64, np.float64),
          (jnp.float32, torch.float32, np.float32)]
C, D = 64, 13
ROUNDS = (0, 1, 7, 1000, 2 ** 31 - 1)


def _draws(jdt, tdt, seed=123456789):
    cid = jnp.arange(C, dtype=jnp.uint32)
    lane = jax.lax.broadcasted_iota(jnp.uint32, (1, D), 1)
    lane_i = jax.lax.broadcasted_iota(jnp.int32, (1, D), 1)
    jd = jmk.make_hash_draw(jnp.int32(seed), cid, lane, lane_i, D, jdt)
    td = tmk.make_hash_draw(seed, torch.arange(C), D, tdt)
    return [(jd(jnp.int32(n)), td(n)) for n in ROUNDS]


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f64", "f32"])
def test_uniforms_and_direction_bits_bitwise(dtypes):
    jdt, tdt, _ = dtypes
    for rj, rt in _draws(jdt, tdt):
        for k in ("h_u", "co_u", "cat_u", "acc_u"):
            assert rt[k].dtype == tdt
            np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]))
        np.testing.assert_array_equal(
            rt["dirs"].numpy().astype(np.uint32), np.asarray(rj["dirs"]))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f64", "f32"])
def test_momenta_within_4_ulp(dtypes):
    jdt, tdt, npdt = dtypes
    for rj, rt in _draws(jdt, tdt):
        a = rt["mom"].numpy()
        b = np.asarray(rj["mom"])
        assert a.shape == b.shape == (C, D) and a.dtype == npdt
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(npdt))
        assert np.all(np.abs(a - b) <= 4 * ulp)


def test_mix32_matches_uint32_arithmetic():
    """The int64 emulation equals the splitmix32 finalizer in numpy's
    wrapping uint32 arithmetic, at the edges of the range."""
    x = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0x9E3779B9,
                  123456789], np.uint32)
    with np.errstate(over="ignore"):
        y = x ^ (x >> np.uint32(16))
        y = y * np.uint32(0x7FEB352D)
        y = y ^ (y >> np.uint32(15))
        y = y * np.uint32(0x846CA68B)
        y = y ^ (y >> np.uint32(16))
    got = tmk._mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), y)
