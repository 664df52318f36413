"""The port's P2 quantile estimator and Hamiltonian helpers against the
JAX package's, in float64."""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.utils import p2 as jp2
from walnuts_tpu_torch.utils import p2 as tp2

# the packages re-export functions under their modules' names
jham = import_module("walnuts_tpu.ops.hamiltonian")
tham = import_module("walnuts_tpu_torch.ops.hamiltonian")

torch.set_num_threads(2)


@pytest.mark.parametrize("prob", [0.2, 0.9])
def test_masked_p2_push_sequence_matches_jax(prob):
    """40 masked pushes per chain: marker heights to 1e-12, marker
    positions and push counts exactly, after every push."""
    rng = np.random.default_rng(int(prob * 10))
    B, steps = 16, 40
    xs = rng.standard_t(3, size=(steps, B))
    masks = rng.random((steps, B)) < 0.7
    sj = jp2.p2_init(prob, (B,), jnp.float64)
    st = tp2.p2_init(prob, (B,), torch.float64)
    push = jax.jit(jp2.p2_push)
    for x, m in zip(xs, masks):
        sj = push(sj, jnp.asarray(x), mask=jnp.asarray(m))
        st = tp2.p2_push(st, torch.from_numpy(x), mask=torch.from_numpy(m))
        np.testing.assert_array_equal(st.npush.numpy(), np.asarray(sj.npush))
        np.testing.assert_array_equal(st.n.numpy(), np.asarray(sj.n))
        np.testing.assert_allclose(st.q.numpy(), np.asarray(sj.q),
                                   rtol=1e-12)
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(sj.x))
    np.testing.assert_allclose(tp2.p2_quantile(st).numpy(),
                               np.asarray(jp2.p2_quantile(sj)), rtol=1e-12)
    assert int(st.npush.min()) > 10  # the steady-state branch ran


def test_p2_unmasked_push_tracks_quantile():
    """Unmasked pushes of 2000 normals: the 0.9 marker lands near the
    true quantile (1.2816)."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2000, 4)))
    s = tp2.p2_init(0.9, (4,), torch.float64)
    for row in x:
        s = tp2.p2_push(s, row)
    assert torch.all((tp2.p2_quantile(s) - 1.2816).abs() < 0.15)


def _qv(seed, shape=(12, 9)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(4)]


def test_kinetic_and_hamiltonian_match_jax():
    q, v, _, _ = _qv(0)
    lp = np.random.default_rng(1).normal(size=q.shape[0])
    inv_mass = np.linspace(0.5, 2.0, q.shape[1])
    for im in (None, inv_mass):
        ke_j = jham.kinetic_energy(jnp.asarray(v),
                                   None if im is None else jnp.asarray(im))
        ke_t = tham.kinetic_energy(
            torch.from_numpy(v), None if im is None else torch.from_numpy(im))
        np.testing.assert_allclose(ke_t.numpy(), np.asarray(ke_j), rtol=1e-12)
    h_j = jham.hamiltonian(jnp.asarray(lp), jnp.asarray(v))
    h_t = tham.hamiltonian(torch.from_numpy(lp), torch.from_numpy(v))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-12)


def test_uturn_matches_jax():
    qe, ve, ql, vl = _qv(2, shape=(200, 5))
    inv_mass = np.linspace(0.5, 2.0, 5)
    for im in (None, inv_mass):
        uj = jham.uturn(*map(jnp.asarray, (qe, ve, ql, vl)),
                        inv_mass=None if im is None else jnp.asarray(im))
        ut = tham.uturn(*map(torch.from_numpy, (qe, ve, ql, vl)),
                        inv_mass=None if im is None else torch.from_numpy(im))
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        assert 0 < int(ut.sum()) < 200


def test_refresh_momentum_takes_a_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tham.refresh_momentum(g1, (64, 7), dtype=torch.float64)
    b = tham.refresh_momentum(g2, (64, 7), dtype=torch.float64)
    assert a.shape == (64, 7) and a.dtype == torch.float64
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    inv_mass = torch.full((7,), 4.0, dtype=torch.float64)
    c = tham.refresh_momentum(torch.Generator().manual_seed(3), (64, 7),
                              inv_mass=inv_mass, dtype=torch.float64)
    torch.testing.assert_close(c, a * 0.5, rtol=0, atol=0)
