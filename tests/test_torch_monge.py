"""The port's Monge-metric integrators against the JAX package's, in
float64 on the CPU: the cached state, the explicit integrator with its
log-Jacobian, the extended-phase-space integrator (JAX's jitter draws)
and the Hamiltonian within rtol 1e-10; reversibility with the
log-Jacobians cancelling; the port's adaptive Dormand-Prince 5(4)
against JAX's ``odeint`` within 1e-7 (both integrate to rtol/atol
1e-10, with their own step-size controllers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.ops import monge as jm
from walnuts_tpu_torch.ops import monge as tm
from walnuts_tpu_torch.utils import threefry

torch.set_num_threads(2)

TARGETS = {
    "corr_gauss095": lambda m: m.targets.corr_gauss(0.95),
    "funnel2": lambda m: m.targets.funnel(2),
}
RTOL = 1e-10


def _qp(seed=0, C=5, D=2):
    rng = np.random.default_rng(seed)
    return 0.5 * rng.normal(size=(C, D)), rng.normal(size=(C, D))


def _close(want, got, label):
    want = np.asarray(want, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.nanmax(np.abs(want)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=label)


def _init(name, q, p):
    return (jm.monge_init(TARGETS[name](wt), jnp.asarray(q), jnp.asarray(p)),
            tm.monge_init(TARGETS[name](tw), torch.from_numpy(q),
                          torch.from_numpy(p)))


@pytest.mark.parametrize("name", list(TARGETS))
def test_monge_init_and_hamiltonian_match_jax(name):
    q, p = _qp()
    sj, st = _init(name, q, p)
    for f in tm.MongeState._fields:
        _close(getattr(sj, f), getattr(st, f), f)
    _close(jm.monge_hamiltonian(TARGETS[name](wt), jnp.asarray(q),
                                jnp.asarray(p)),
           tm.monge_hamiltonian(TARGETS[name](tw), torch.from_numpy(q),
                                torch.from_numpy(p)), "hamiltonian")
    fj, ft = jm.monge_flip(sj), tm.monge_flip(st)
    _close(fj.hv, ft.hv, "flip hv")


@pytest.mark.parametrize("name", list(TARGETS))
def test_monge_int_matches_jax_and_is_reversible(name):
    q, p = _qp(1)
    sj, st = _init(name, q, p)
    h = np.linspace(0.05, 0.2, 5)
    oj, lj = jm.monge_int(TARGETS[name](wt), sj, jnp.asarray(h), 6)
    ot, lt = tm.monge_int(TARGETS[name](tw), st, torch.from_numpy(h), 6)
    for f in tm.MongeState._fields:
        _close(getattr(oj, f), getattr(ot, f), f)
    _close(lj, lt, "log_jac")
    # integrate back from the flipped end state: the start again, and
    # the two log-Jacobians cancel
    back, lb = tm.monge_int(TARGETS[name](tw), tm.monge_flip(ot),
                            torch.from_numpy(h), 6)
    np.testing.assert_allclose(back.q.numpy(), q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(-back.p.numpy(), p, rtol=0, atol=1e-12)
    np.testing.assert_allclose((lt + lb).numpy(), 0.0, atol=1e-12)
    assert float(lt.abs().max()) > 1e-6  # a volume change that cancels


@pytest.mark.parametrize("name", list(TARGETS))
def test_monge_eps_int_matches_jax(name):
    q, p = _qp(2)
    kw = dict(h=0.1, omega=100.0, nstep=4)
    want = jm.monge_eps_int(TARGETS[name](wt), jnp.asarray(q), jnp.asarray(p),
                            key=jax.random.PRNGKey(3), **kw)
    got = tm.monge_eps_int(TARGETS[name](tw), torch.from_numpy(q),
                           torch.from_numpy(p), key=threefry.PRNGKey(3), **kw)
    for label, a, b in zip(("q", "p", "qt", "pt"), want, got):
        _close(a, b, label)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    # with the copy given, no key is needed
    again = tm.monge_eps_int(TARGETS[name](tw), torch.from_numpy(q),
                             torch.from_numpy(p), got[2], got[3], **kw)
    assert again[0].shape == (5, 2)
    with pytest.raises(ValueError, match="key"):
        tm.monge_eps_int(TARGETS[name](tw), torch.from_numpy(q),
                         torch.from_numpy(p))


@pytest.mark.parametrize("name", list(TARGETS))
def test_monge_int_adapt_matches_jax_odeint(name):
    q, p = _qp(3, C=3)
    want = jm.monge_int_adapt(TARGETS[name](wt), jnp.asarray(q),
                              jnp.asarray(p), 0.5)
    got = tm.monge_int_adapt(TARGETS[name](tw), torch.from_numpy(q),
                             torch.from_numpy(p), 0.5)
    err = max(float(np.abs(np.asarray(a) - b.numpy()).max())
              for a, b in zip(want, got))
    print(f"monge_int_adapt {name}: max abs diff against JAX's odeint "
          f"{err:.3e}")
    assert err < 1e-7
    # the exact flow conserves the Monge Hamiltonian
    h0 = tm.monge_hamiltonian(TARGETS[name](tw), torch.from_numpy(q),
                              torch.from_numpy(p))
    h1 = tm.monge_hamiltonian(TARGETS[name](tw), *got)
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), atol=1e-8)
