"""The port's Stock-Watson target and its run through the fused engine,
against the JAX package's, in float64 on the CPU.

The target at the full series (T = 252, D = 756), both models: the log
density, the analytic gradient (JAX takes its gradient from autodiff)
and the stored summary within rtol 1e-10, and the Hessian-vector
product.  The autograd-only Hessian-vector product, which raised inside
``torch.func`` before ``Target.hvp`` took the functional gradient.  The
fused engine's plain path (the CUDA kernel's twin) on a T = 12 series
against JAX's ``run_walnuts_fused(rng="hash")`` under the example's
three protocols: integers equal, floats within ``EXACT``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.sampler.megakernel import run_walnuts_fused as jax_fused
from walnuts_tpu_torch.sampler.megakernel import MState, mstate_to_numpy
from walnuts_tpu_torch.utils.parity import EXACT

torch.set_num_threads(2)

T = 252
RTOL = 1e-10


def _q(C=6, scale=0.3, seed=0):
    return scale * np.random.default_rng(seed).normal(size=(C, 3 * T))


@pytest.mark.parametrize("proper", [False, True])
def test_logp_grad_generated_match_jax(proper):
    tj = wt.targets.stock_watson(proper=proper)
    tt = tw.targets.stock_watson(proper=proper)
    assert tt.dim == tj.dim == 3 * T and tt.generated_dim == 3 * T
    assert tt.kernel_id == "stock_watson"
    assert tt.kernel_args["T"] == T and tt.kernel_args["proper"] == proper
    q = _q()
    lp_j, g_j = tj.logp_grad(jnp.asarray(q))
    lp_t, g_t = tt.logp_grad(torch.from_numpy(q))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL)
    np.testing.assert_allclose(tt.logp(torch.from_numpy(q)).numpy(),
                               np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(tt.generated(torch.from_numpy(q)).numpy(),
                               np.asarray(tj.generated(jnp.asarray(q))),
                               rtol=RTOL)
    # the analytic gradient is the autograd gradient of the log density
    qa = torch.from_numpy(q).requires_grad_(True)
    (g_a,) = torch.autograd.grad(tt.logp(qa).sum(), qa)
    np.testing.assert_allclose(g_t.numpy(), g_a.numpy(), rtol=RTOL,
                               atol=RTOL * float(g_a.abs().max()))
    # one position, unbatched
    lp1, g1 = tt.logp_grad(torch.from_numpy(q[0]))
    np.testing.assert_allclose(g1.numpy(), g_t[0].numpy(), rtol=1e-14)


def test_reference_model_has_flat_z1_tail():
    """``sw_innov.stan:40-42`` comments out the initial-state priors: the
    reference model is exactly flat as z1 -> -inf, the proper one decays
    quadratically, and near the origin they differ by the prior term."""
    t_ref = tw.targets.stock_watson()
    t_prop = tw.targets.stock_watson(proper=True)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=3 * T) * 0.5)
    q[1] = -130.0
    q2 = q.clone()
    q2[1] -= 900.0
    assert float(t_ref.logp(q)) == float(t_ref.logp(q2))
    assert abs(float(t_ref.grad(q)[1])) < 1e-20  # e^{z_t/2} underflows
    dp = float(t_prop.logp(q)) - float(t_prop.logp(q2))
    np.testing.assert_allclose(dp, 0.5 * (1030.0 ** 2 - 130.0 ** 2),
                               rtol=1e-6)
    q0 = torch.from_numpy(rng.normal(size=3 * T) * 0.1)
    z1, x1, tau1 = float(q0[1]), float(q0[T]), float(q0[2 * T])
    np.testing.assert_allclose(
        float(t_ref.logp(q0)) - float(t_prop.logp(q0)),
        0.5 * (z1 ** 2 + x1 ** 2 + tau1 ** 2 + 3 * np.log(2 * np.pi)),
        rtol=1e-6)


def test_hvp_matches_jax():
    """The Hessian-vector product of the analytic gradient, and of an
    autograd-only Stock-Watson target (its scalar log density alone),
    against JAX's forward-over-reverse."""
    tj = wt.targets.stock_watson(proper=True)
    tt = tw.targets.stock_watson(proper=True)
    q, v = _q(C=3, seed=1), _q(C=3, scale=1.0, seed=2)
    want = np.asarray(tj.hvp(jnp.asarray(q), jnp.asarray(v)))
    bare = tw.Target(tt._logp, tt.dim)
    for t in (tt, bare):
        got = t.hvp(torch.from_numpy(q), torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["rosenbrock", "smile"])
def test_autograd_target_hvp_matches_jax(name):
    """``Target.hvp`` on a target with no analytic gradient: forward
    over the functional gradient, not over ``logp_grad``'s autograd
    path (which raises inside ``torch.func.jvp``)."""
    rng = np.random.default_rng(4)
    q, v = rng.normal(size=(5, 2)), rng.normal(size=(5, 2))
    tt = getattr(tw.targets, name)()
    assert tt._logp_grad is None
    want = np.asarray(getattr(wt.targets, name)().hvp(jnp.asarray(q),
                                                      jnp.asarray(v)))
    got = tt.hvp(torch.from_numpy(q), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300)
    quartic = tw.Target(lambda x: -0.25 * torch.sum(x ** 4), 2)
    np.testing.assert_allclose(
        quartic.hvp(torch.from_numpy(q), torch.from_numpy(v)).numpy(),
        -3.0 * q ** 2 * v, rtol=1e-14)


# the example's three protocols (examples/stock_watson.py:CONFIGS), with
# m cut so that 160 rounds complete transitions at T = 12
PROTOCOLS = {
    "walnuts_d": ("adapt_leapfrog_d", 0.1, dict(min_c=3), 4, 4),
    "walnuts_r2p": ("adapt_leapfrog_r2p", 0.1, dict(min_c=3), 4, 4),
    "nuts": ("fixed_leapfrog", 0.02, {}, 6, 1),
}


@pytest.fixture(scope="module")
def sw12(tmp_path_factory):
    """A T = 12 series (the first 12 rows of swdata.json), D = 36."""
    _, y = tw.targets.load_sw_data()
    path = tmp_path_factory.mktemp("sw") / "sw12.json"
    path.write_text(json.dumps({"T": 12, "y": y[:12].tolist()}))
    return str(path)


@pytest.mark.parametrize("arm", list(PROTOCOLS))
def test_fused_plain_path_matches_jax(sw12, arm):
    integ, h0, igr, m, unroll = PROTOCOLS[arm]
    C = 8
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(jax.random.fold_in(key, 777), (1,), 0,
                                  2 ** 30, jnp.int32)[0])
    q0 = 0.3 * np.random.default_rng(5).normal(size=(C, 36))
    kw = dict(num_iter=20, stop_mode="min_per_chain", diag_rows=8,
              rounds=160, micro_unroll=unroll)
    want = jax_fused(key, jnp.asarray(q0), jnp.full((C,), h0),
                     jnp.full((C,), 0.3),
                     target=wt.targets.stock_watson(sw12, proper=True),
                     cfg=wt.WalnutsConfig(m=m, integrator=integ,
                                          igr=wt.IntegratorConfig(**igr)),
                     rng="hash", **kw)[-1]
    got = tw.run_walnuts_fused(
        seed, torch.from_numpy(q0), torch.full((C,), h0, dtype=torch.float64),
        torch.full((C,), 0.3, dtype=torch.float64),
        target=tw.targets.stock_watson(sw12, proper=True),
        cfg=tw.WalnutsConfig(m=m, integrator=integ,
                             igr=tw.IntegratorConfig(**igr)),
        device="cpu", **kw)[-1]
    port = mstate_to_numpy(got)
    for name in MState._fields:
        if name in ("p2h", "p2d"):
            continue
        a, b = np.asarray(getattr(want, name)), port[name]
        assert a.shape == b.shape, name
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=name)
        else:
            np.testing.assert_allclose(b, a.astype(np.float64),
                                       err_msg=name, **EXACT)
    assert int(port["it"].sum()) > 0   # draws were staged and stored
    assert np.abs(port["samples"]).sum() > 0
