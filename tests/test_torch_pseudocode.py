"""The port's paper-pseudocode mode against the JAX package's, in float64
on the CPU: the micro-step draws bitwise, the pmf and ``stable_steps``
exactly, and the transitions and the chain driver (positions, gradient
counts, stopping depths) under the exact contract
(``walnuts_tpu_torch.utils.parity.EXACT``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.sampler import pseudocode as jp
from walnuts_tpu_torch.sampler import pseudocode as tp
from walnuts_tpu_torch.utils import threefry
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

torch.set_num_threads(2)


def _key(seed):
    return threefry.PRNGKey(seed)


@pytest.mark.parametrize("policy", ["uniform_3", "shifted_23"])
def test_choose_micro_steps_bitwise(policy):
    ells = np.random.default_rng(0).integers(1, 17, size=300).astype(np.int32)
    want = jp.choose_micro_steps(jax.random.PRNGKey(4), jnp.asarray(ells),
                                 policy)
    got = tp.choose_micro_steps(_key(4), torch.from_numpy(ells), policy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 1


@pytest.mark.parametrize("policy", ["uniform_3", "shifted_23"])
def test_micro_steps_logp_matches_jax(policy):
    ell = np.asarray([1, 2, 4, 8, 3, 1, 2, 16, 5], np.int32)
    st = np.asarray([1, 1, 4, 4, 4, 2, 2, 8, 5], np.int32)
    want = np.asarray(jp.micro_steps_logp(jnp.asarray(ell), jnp.asarray(st),
                                          policy))
    got = tp.micro_steps_logp(torch.from_numpy(ell), torch.from_numpy(st),
                              policy).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-15)


def test_stable_steps_matches_jax():
    rng = np.random.default_rng(1)
    q, rho = rng.normal(size=(8, 10)), rng.normal(size=(8, 10))
    act = np.arange(8) != 3           # one chain inactive
    for macro in (0.5, 2.0):
        want = jp.stable_steps(wt.targets.std_gauss(10), jnp.asarray(q),
                               jnp.asarray(rho), jnp.ones(10),
                               jnp.full((8,), macro), 0.05, jnp.asarray(act))
        got = tp.stable_steps(
            tw.targets.std_gauss(10), torch.from_numpy(q),
            torch.from_numpy(rho), torch.ones(10, dtype=torch.float64),
            torch.full((8,), macro, dtype=torch.float64), 0.05,
            torch.from_numpy(act))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gumbel_matches_jax():
    """``threefry.gumbel`` against ``jax.random.gumbel`` (mode "low"):
    the uniforms are bitwise JAX's, the two logarithms agree to a few
    ulp."""
    for dtype, jdt, rtol in ((torch.float64, jnp.float64, 1e-14),
                             (torch.float32, jnp.float32, 1e-6)):
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(3), (64, 5),
                                            jdt))
        got = threefry.gumbel(_key(3), (64, 5), dtype).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


CASES = {
    # the reference smoke test's target and macro step (test/test.py)
    "std_gauss2": (lambda m: m.targets.std_gauss(2), 2, 1.0, 2.0, 6, 0.1),
    # an ill-conditioned Gaussian with the variances as inverse mass
    "ill_gauss4_mass": (lambda m: m.targets.ill_conditioned_gauss(4, 100.0),
                        4, np.logspace(0.0, 2.0, 4), 1.5, 5, 0.1),
    "funnel6": (lambda m: m.targets.funnel(6), 6, 1.0, 0.5, 5, 0.2),
}


def _q0(D, C=6, seed=0):
    return 0.5 * np.random.default_rng(seed).normal(size=(C, D))


@pytest.mark.parametrize("case", list(CASES))
def test_walnuts_step_pseudo_matches_jax(case):
    make, D, inv_mass, macro, depth, err = CASES[case]
    q0 = _q0(D)
    im = np.broadcast_to(np.asarray(inv_mass, np.float64), (D,))
    want = jp.walnuts_step_pseudo(
        jax.random.PRNGKey(2), jnp.asarray(q0), target=make(wt),
        inv_mass=jnp.asarray(im), macro_step=macro, max_depth=depth,
        max_error=err)
    got = tp.walnuts_step_pseudo(
        _key(2), torch.from_numpy(q0), target=make(tw),
        inv_mass=torch.from_numpy(im.copy()), macro_step=macro,
        max_depth=depth, max_error=err)
    assert_parity(np.asarray(want.q), got.q.numpy(), EXACT, "q")
    assert_parity(np.asarray(want.n_grad), got.n_grad.numpy(), EXACT, "n_grad")
    assert_parity(np.asarray(want.depth_stopped), got.depth_stopped.numpy(),
                  EXACT, "depth_stopped")
    assert int(got.n_grad.min()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_walnuts_pseudo_matches_jax(case):
    make, D, inv_mass, macro, depth, err = CASES[case]
    q0 = _q0(D, C=4, seed=1)
    kw = dict(inv_mass=inv_mass, macro_step=macro, max_depth=depth,
              max_error=err, iter_warmup=2, iter_sample=3)
    want = jp.walnuts_pseudo(jax.random.PRNGKey(5), jnp.asarray(q0),
                             target=make(wt), **kw)
    got = tp.walnuts_pseudo(_key(5), q0, target=make(tw), device="cpu", **kw)
    assert got.shape == (3, 4, D)
    assert_parity(np.asarray(want), got.numpy(), EXACT, "draws")


def test_walnuts_pseudo_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.walnuts_pseudo(5, np.zeros((2, 2)), target=tw.targets.std_gauss(2),
                          inv_mass=1.0, macro_step=1.0, iter_sample=1)
