"""The port's integrator layer (``walnuts_tpu_torch.ops``) against the
JAX package's, float64 on the CPU, on the same numpy-seeded inputs:
``masked_multistep`` over every step function and all seven adaptive
integrators (plus Newton mode) on std_gauss(5) and funnel(5), C=16, a
mix of active and inactive chains, both directions.  Integer outputs
equal, floats within rtol 1e-10.  Below them, torch versions of the
JAX-side invariant tests (``tests/test_integrators.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.ops import integrators as jint
from walnuts_tpu.ops import leapfrog as jlf
from walnuts_tpu.ops.hamiltonian import hamiltonian as jham
from walnuts_tpu_torch.ops import integrators as tint
from walnuts_tpu_torch.ops import leapfrog as tlf
from walnuts_tpu_torch.ops.hamiltonian import hamiltonian as tham
from walnuts_tpu_torch.utils import threefry

C = 16
TARGETS = ["std_gauss", "funnel"]
INT_FIELDS = ("i_f", "i_b", "c", "n_eval_f", "n_eval_b")
RTOL = dict(rtol=1e-10, atol=1e-12)


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(C, 5))
    v = rng.normal(size=(C, 5))
    active = rng.random(C) < 0.75
    xi = np.where(rng.random(C) < 0.5, 1.0, -1.0)
    return (getattr(wt.targets, name)(5), getattr(tw.targets, name)(5),
            q, v, active, xi)


def _coin(seed, n):
    """R2P's coin as the JAX integrator draws it from ``PRNGKey(seed)``."""
    return threefry.uniform(threefry.PRNGKey(seed), (n,), torch.float64)


def _check(want, got, noise=()):
    """Integers equal, floats within rtol 1e-10; the fields in ``noise``
    only positive and finite on both sides."""
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(b, tuple):
            _check(a, b)
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=f)
        elif f in noise:
            assert np.all(np.isfinite(a) & (a > 0)), f
            assert np.all(np.isfinite(b) & (b > 0)), f
        else:
            np.testing.assert_allclose(b, a, err_msg=f, **RTOL)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("step", sorted(tlf.STEP_FNS))
def test_masked_multistep_matches_jax(target, step):
    jt, tt, q, v, _, _ = _inputs(target)
    n = np.random.default_rng(1).integers(0, 6, size=C).astype(np.int32)
    h = np.full(C, 0.15)
    jlp, jg = jt.logp_grad(jnp.asarray(q))
    want = jlf.masked_multistep(
        jt, jlf.PhasePoint(jnp.asarray(q), jnp.asarray(v), jg, jlp),
        jham(jlp, jnp.asarray(v)), jnp.asarray(h), jnp.asarray(n), None,
        jlf.STEP_FNS[step])
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    tlp, tg = tt.logp_grad(tq)
    got = tlf.masked_multistep(
        tt, tlf.PhasePoint(tq, tv, tg, tlp), tham(tlp, tv),
        torch.from_numpy(h), torch.from_numpy(n), None, tlf.STEP_FNS[step])
    _check(want, got)
    assert int(got.n_evals.sum()) > 0


INTEGRATOR_CASES = [(name, {}) for name in sorted(tint.INTEGRATORS)] + [
    ("adapt_implicit_midpoint_d", {"fp_newton": True}),
    ("adapt_leapfrog_d", {"min_c": 1, "max_c": 6}),
]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name,cfg_kw", INTEGRATOR_CASES,
                         ids=[f"{n}{'-' if k else ''}{'-'.join(k)}"
                              for n, k in INTEGRATOR_CASES])
def test_integrator_matches_jax(target, name, cfg_kw):
    jt, tt, q, v, active, xi = _inputs(target, seed=2)
    h_macro, delta = np.full(C, 0.5), np.full(C, 0.08)
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    jlp, jg = jt.logp_grad(jq)
    want = jint.get_integrator(name)(
        jax.random.PRNGKey(4), jt, jq, jv, jg, jlp, jham(jlp, jv),
        jnp.asarray(h_macro), jnp.asarray(xi), jnp.asarray(delta), None,
        jnp.asarray(active), jint.IntegratorConfig(**cfg_kw))
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    tlp, tg = tt.logp_grad(tq)
    got = tint.get_integrator(name)(
        _coin(4, C), tt, tq, tv, tg, tlp, tham(tlp, tv),
        torch.from_numpy(h_macro), torch.from_numpy(xi),
        torch.from_numpy(delta), None, torch.from_numpy(active),
        tint.IntegratorConfig(**cfg_kw))
    # the implicit midpoint rule conserves a quadratic energy exactly, so
    # on std_gauss max|dH| is zero or a rounding unit and igr_const =
    # h max(max|dH|, 1e-30)^(-1/3) is rounding noise on both sides
    noisy = name.startswith("adapt_implicit") and target == "std_gauss"
    _check(want, got, noise=("igr_const",) if noisy else ())
    for f in INT_FIELDS:
        assert getattr(got, f).dtype == torch.int32, f
    idle = ~active
    np.testing.assert_array_equal(got.q.numpy()[idle], q[idle])
    assert np.all(got.n_eval_f.numpy()[idle] == 0)


# ---- torch versions of the JAX-side invariants ------------------------

def _setup(t, n=8, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(n, t.dim)))
    v = torch.from_numpy(rng.normal(size=(n, t.dim)))
    lp, g = t.logp_grad(q)
    return q, v, g, lp


def test_leapfrog_reversibility():
    t = tw.targets.funnel(11)
    q, v, g, lp = _setup(t)
    h = torch.full((8,), 0.01, dtype=torch.float64)
    n = torch.full((8,), 16, dtype=torch.int32)
    fwd = tlf.masked_multistep(t, tlf.PhasePoint(q, v, g, lp), tham(lp, v),
                               h, n)
    s = fwd.state
    back = tlf.masked_multistep(t, tlf.PhasePoint(s.q, -s.v, s.g, s.lp),
                                fwd.h_end, h, n)
    torch.testing.assert_close(back.state.q, q, rtol=0, atol=1e-9)
    torch.testing.assert_close(-back.state.v, v, rtol=0, atol=1e-9)


@pytest.mark.parametrize("step,h,ratio", [
    (tlf.leapfrog_step, 0.1, 2.5), (tlf.yoshida_step, 0.2, 8.0)])
def test_energy_error_order(step, h, ratio):
    """Halving the step cuts the endpoint energy error ~4x (leapfrog) or
    ~16x (Yoshida)."""
    t = tw.targets.std_gauss(4)
    q, v, g, lp = _setup(t, n=4)

    def err(hh, n):
        r = tlf.masked_multistep(
            t, tlf.PhasePoint(q, v, g, lp), tham(lp, v),
            torch.full((4,), hh, dtype=torch.float64),
            torch.full((4,), n, dtype=torch.int32), None, step)
        return torch.abs(r.h_end - tham(lp, v))

    e1, e2 = err(h, 8), err(h / 2, 16)
    assert torch.all(e1 / torch.clamp(e2, min=1e-300) > ratio)


def test_adapt_d_meets_tolerance_and_hard_rejects():
    t = tw.targets.funnel(11)
    q, v, g, lp = _setup(t, n=32, seed=5)
    n = q.shape[0]
    h0 = tham(lp, v)
    res = tint.adapt_leapfrog_d(
        None, t, q, v, g, lp, h0, torch.full((n,), 0.8, dtype=torch.float64),
        torch.ones(n, dtype=torch.float64),
        torch.full((n,), 0.05, dtype=torch.float64), None,
        torch.ones(n, dtype=torch.bool), tint.IntegratorConfig())
    err = torch.abs(res.h_end - h0)
    assert torch.all((err < 0.05) | (res.i_f == 10))
    same = res.i_f == res.i_b
    assert torch.all(res.lwt[same] == 0.0)
    assert torch.all(res.lwt[~same] < -600.0)


def test_r2p_weight_support():
    t = tw.targets.funnel(11)
    q, v, g, lp = _setup(t, n=64, seed=9)
    n = q.shape[0]
    res = tint.adapt_leapfrog_r2p(
        _coin(4, n), t, q, v, g, lp, tham(lp, v),
        torch.full((n,), 0.5, dtype=torch.float64),
        torch.ones(n, dtype=torch.float64),
        torch.full((n,), 0.1, dtype=torch.float64), None,
        torch.ones(n, dtype=torch.bool), tint.IntegratorConfig())
    c, i_f, i_b = res.c.numpy(), res.i_f.numpy(), res.i_b.numpy()
    assert np.all((c == i_f) | (c == i_f + 1))
    p0, p1 = np.log(2.0 / 3.0), np.log(1.0 / 3.0)
    want = (np.where(c == i_b, p0, np.where(c == i_b + 1, p1, -700.0))
            - np.where(c == i_f, p0, p1))
    np.testing.assert_allclose(res.lwt.numpy(), want, atol=1e-12)


def test_target_hessian_matches_jax():
    q = np.random.default_rng(3).normal(size=(4, 5))
    jt, tt = wt.targets.funnel(5), tw.targets.funnel(5)
    np.testing.assert_allclose(
        tt.hessian_batched(torch.from_numpy(q)).numpy(),
        np.asarray(jt.hessian_batched(jnp.asarray(q))), rtol=1e-12)
    v = np.ones((4, 5))
    np.testing.assert_allclose(
        tt.hvp(torch.from_numpy(q), torch.from_numpy(v)).numpy(),
        np.asarray(jt.hvp(jnp.asarray(q), jnp.asarray(v))), rtol=1e-12)


def test_get_integrator_unknown():
    with pytest.raises(ValueError, match="unknown integrator"):
        tw.get_integrator("nope")
