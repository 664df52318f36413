"""The port's fused engine (plain round body on the CPU) against the JAX
engine ``run_walnuts_fused(rng="hash")``, under the exact float64
contract: funnel(7), C=16, m=4, 160 rounds; every integer field equal,
every float field, ring and P2 marker to rtol 1e-9, atol 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.sampler.megakernel import run_walnuts_fused as jax_fused
from walnuts_tpu_torch.sampler.megakernel import (MState, mstate_from_numpy,
                                                  mstate_to_numpy)
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT, assert_parity

torch.set_num_threads(2)

C, D, M = 16, 7, 4
KEY = jax.random.PRNGKey(5)
# the JAX engine's hash seed derivation (megakernel.py:1258-1259)
SEED = int(jax.random.randint(jax.random.fold_in(KEY, 777), (1,), 0,
                              2 ** 30, jnp.int32)[0])
Q0 = 0.3 * np.random.default_rng(0).normal(size=(C, D))
FIXED = dict(num_iter=50, stop_mode="min_per_chain", diag_rows=8)
WARM = dict(num_iter=20, stop_mode="per_chain", micro_unroll=4, diag_rows=8)
WARMUP = dict(warmup_iter=20, pooled=True)


def _jax(rounds, warmup=None, **kw):
    return jax_fused(
        KEY, jnp.asarray(Q0), jnp.full((C,), 0.4), jnp.full((C,), 0.15),
        target=wt.targets.funnel(D), cfg=wt.WalnutsConfig(m=M),
        warmup=None if warmup is None else wt.WarmupConfig(**warmup),
        rounds=rounds, rng="hash", **kw)


def _port(rounds, warmup=None, mk_state=None, q0=Q0, seed=SEED, **kw):
    n = q0.shape[0]
    return tw.run_walnuts_fused(
        seed, torch.from_numpy(q0), torch.full((n,), 0.4, dtype=torch.float64),
        torch.full((n,), 0.15, dtype=torch.float64),
        target=tw.targets.funnel(D), cfg=tw.WalnutsConfig(m=M),
        warmup=None if warmup is None else tw.WarmupConfig(**warmup),
        rounds=rounds, mk_state=mk_state, device="cpu", **kw)


def _jax_numpy(st):
    return {f: (jax.tree.map(np.asarray, v) if f in ("p2h", "p2d")
                else np.asarray(v)) for f, v in st._asdict().items()}


def _assert_states_match(jax_st, port_st, rtol=EXACT["rtol"],
                         atol=EXACT["atol"]):
    want = _jax_numpy(jax_st)
    got = mstate_to_numpy(port_st)
    for name in MState._fields:
        if name in ("p2h", "p2d"):
            pairs = [(f"{name}.{f}", np.asarray(getattr(want[name], f)),
                      got[name][f]) for f in want[name]._fields]
        else:
            pairs = [(name, want[name], got[name])]
        for label, a, b in pairs:
            assert a.shape == b.shape, label
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(
                    b.astype(np.int64), a.astype(np.int64), err_msg=label)
            else:
                np.testing.assert_allclose(b, a.astype(np.float64),
                                           rtol=rtol, atol=atol,
                                           err_msg=label)


@pytest.fixture(scope="module")
def jax_fixed_160():
    return _jax(160, **FIXED)


@pytest.fixture(scope="module")
def jax_fixed_80():
    return _jax(80, **FIXED)


@pytest.fixture(scope="module")
def jax_warm_160():
    return _jax(160, warmup=WARMUP, **WARM)


def test_fixed_tuning_matches_jax(jax_fixed_160):
    out = _port(160, **FIXED)
    _assert_states_match(jax_fixed_160[-1], out[-1])
    assert out[4] == int(np.asarray(jax_fixed_160[-1].grad_ct).sum()) > 0
    assert int(out[3].sum()) > C  # transitions completed and stored
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jax_fixed_160[0]),
                               rtol=1e-9, atol=1e-12)


def test_pooled_warmup_micro_unroll_matches_jax(jax_warm_160):
    out = _port(160, warmup=WARMUP, **WARM)
    _assert_states_match(jax_warm_160[-1], out[-1])
    h, delta = out[5], out[6]
    assert float(h.max() - h.min()) == 0.0  # one consensus (H, delta)
    assert float(h[0]) != 0.4  # adapted (delta waits for 10 transitions)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jax_warm_160[6]),
                               rtol=1e-9)
    np.testing.assert_allclose(h.numpy(), np.asarray(jax_warm_160[5]),
                               rtol=1e-9)


def test_resume_from_jax_state(jax_fixed_80, jax_fixed_160):
    """A run started in JAX continues in the port: JAX's state after 80
    rounds, carried over, plus 80 port rounds equals JAX's 160."""
    st = mstate_from_numpy(_jax_numpy(jax_fixed_80[-1]))
    assert st.n == 80
    out = _port(80, mk_state=st, **FIXED)
    _assert_states_match(jax_fixed_160[-1], out[-1])


def test_per_chain_warmup_at_d80_drifts_past_the_exact_contract():
    """The adaptive contract (``walnuts_tpu_torch.utils.parity``), pinned
    on its defining case.  Per-chain warmup adapts H from energy
    differences, which magnifies the rounding of sums over D taken in
    other orders (XLA's CPU backend does not sum a row of 80 in sequence,
    torch neither): on std_gauss(80), C=48, m=5, float64, after 160 rounds
    the JAX engine and the port keep every integer equal, but their
    floats drift past the exact contract and stay within ``ADAPTIVE``.
    ``test_torch_round_kernel_gpu.py`` holds the CUDA kernel to the same
    bound against the port on these inputs."""
    key = jax.random.PRNGKey(77)
    seed = int(jax.random.randint(jax.random.fold_in(key, 777), (1,), 0,
                                  2 ** 30, jnp.int32)[0])
    assert seed == 506380528  # the GPU test's seed for this case
    n, dim = 48, 80
    q0 = 0.3 * torch.randn(n, dim, generator=torch.Generator().manual_seed(5),
                           dtype=torch.float64)
    kw = dict(num_iter=12, stop_mode="per_chain", rounds=160, diag_rows=4)
    want = jax_fused(key, jnp.asarray(q0.numpy()), jnp.full((n,), 0.4),
                     jnp.full((n,), 0.2), target=wt.targets.std_gauss(dim),
                     cfg=wt.WalnutsConfig(m=5),
                     warmup=wt.WarmupConfig(warmup_iter=8), rng="hash",
                     **kw)[-1]
    got = tw.run_walnuts_fused(
        seed, q0, torch.full((n,), 0.4, dtype=torch.float64),
        torch.full((n,), 0.2, dtype=torch.float64),
        target=tw.targets.std_gauss(dim), cfg=tw.WalnutsConfig(m=5),
        warmup=tw.WarmupConfig(warmup_iter=8), device="cpu", **kw)[-1]
    _assert_states_match(want, got, **ADAPTIVE)
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        _assert_states_match(want, got, **EXACT)
    assert int(got.it.sum()) > 0


def test_mstate_numpy_round_trip(jax_fixed_80):
    st = mstate_from_numpy(_jax_numpy(jax_fixed_80[-1]))
    back = mstate_to_numpy(st)
    again = mstate_to_numpy(mstate_from_numpy(back))
    for name in MState._fields:
        a, b = back[name], again[name]
        if isinstance(a, dict):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f])
        else:
            np.testing.assert_array_equal(a, b)
    assert back["xi_bits"].dtype == np.uint32
    assert st.xi_bits.dtype == torch.int64 and st.t.dtype == torch.int32


def test_per_chain_reproducible():
    """A chain's trajectory depends on its global id alone: the first 4
    chains of an 8-chain run replay the 4-chain run bitwise."""
    kw = dict(num_iter=8, stop_mode="min_per_chain", diag_rows=8)
    s8, d8, *_ = _port(None, q0=Q0[:8], **kw)
    s4, d4, *_ = _port(None, q0=Q0[:4], **kw)
    assert s8.shape == (8, 8, D)
    torch.testing.assert_close(s8[:, :4], s4, rtol=0, atol=0)
    torch.testing.assert_close(d8[:, :4], d4, rtol=0, atol=0)


@pytest.mark.parametrize("stop_mode", ["per_chain", "total", "min_per_chain"])
def test_stop_modes_and_returns(stop_mode):
    out = _port(None, q0=Q0[:6], num_iter=5, stop_mode=stop_mode,
                ring_rows=4, diag_rows=2)
    samples, diags, qc, counts, grads = out
    assert samples.shape == (4, 6, D) and diags.shape == (2, 6, 24)
    assert qc.shape == (6, D) and isinstance(grads, int) and grads > 0
    if stop_mode == "per_chain":
        assert torch.all(counts == 5)
    elif stop_mode == "total":
        assert int(counts.sum()) >= 30
    else:
        assert int(counts.min()) >= 5
    assert torch.isfinite(samples).all() and torch.isfinite(qc).all()


def test_invalid_arguments_raise():
    with pytest.raises(ValueError, match="integrator"):
        tw.run_walnuts_fused(
            1, torch.zeros(2, 3, dtype=torch.float64), 0.1, 0.1,
            target=tw.targets.std_gauss(3), num_iter=1,
            cfg=tw.WalnutsConfig(m=4, integrator="adapt_yoshida_d"),
            device="cpu")
    with pytest.raises(ValueError, match="stop_mode"):
        tw.run_walnuts_fused(
            1, torch.zeros(2, 3, dtype=torch.float64), 0.1, 0.1,
            target=tw.targets.std_gauss(3), num_iter=1,
            cfg=tw.WalnutsConfig(m=4), stop_mode="forever", device="cpu")


def _own_summary_jax(q):
    return jnp.stack([q[..., 0], jnp.sum(q[..., 1:] ** 2, axis=-1)], -1)


def _own_summary(q):
    """``bench.py``'s (omega, sum x^2) as a function of its own (the
    kernel stores ``omega_sumsq`` only; this one it stages for torch)."""
    return torch.stack([q[..., 0], torch.sum(q[..., 1:] ** 2, dim=-1)], -1)


def _user_logp(q):
    """A user's density, written once for both packages: a log density
    over one ``[3]`` position and no gradient (autodiff in JAX, autograd
    in the port)."""
    return (-0.5 * (q[0] ** 2 + (q[1] - 0.5 * q[0] ** 2) ** 2)
            - 0.125 * q[2] ** 2)


# each case: (JAX target, the port's target); all but the last two have
# no fused gradient in the CUDA kernel
UNFUSED = {
    "smile": lambda pkg: pkg.targets.smile(),
    "corr_gauss": lambda pkg: pkg.targets.corr_gauss(),
    "rosenbrock": lambda pkg: pkg.targets.rosenbrock(),
    "mod_funnel": lambda pkg: pkg.targets.mod_funnel(),
    "funnel_rescaled": lambda pkg: pkg.targets.funnel_rescaled(5),
    "ill_conditioned_gauss": lambda pkg: pkg.targets.ill_conditioned_gauss(5),
    "user_lambda": lambda pkg: pkg.Target(_user_logp, 3, name="user"),
    "funnel_own_summary": lambda pkg: pkg.targets.funnel(
        D, generated=_own_summary_jax if pkg is wt else _own_summary),
}


@pytest.mark.parametrize("case", list(UNFUSED))
def test_unfused_target_and_own_summary_match_jax(case):
    """What the CUDA kernel does not fuse, in the plain engine on the CPU
    against JAX's engine: every target without a fused gradient (the
    analytic ones, and a user's ``logp`` with no gradient, whose gradient
    comes from autograd) and the funnel with a summary of the user's own;
    160 rounds, EXACT.  On the card these run through the kernel's
    external-gradient instantiation, which the GPU tests hold against
    this plain engine."""
    jt, pt = UNFUSED[case](wt), UNFUSED[case](tw)
    q0 = Q0[:, :jt.dim]
    kw = dict(num_iter=12, stop_mode="per_chain", diag_rows=4,
              micro_unroll=2, rounds=160)
    want = jax_fused(KEY, jnp.asarray(q0), jnp.full((C,), 0.3),
                     jnp.full((C,), 0.2), target=jt,
                     cfg=wt.WalnutsConfig(m=5), rng="hash", **kw)
    got = tw.run_walnuts_fused(
        SEED, torch.from_numpy(q0), torch.full((C,), 0.3, dtype=torch.float64),
        torch.full((C,), 0.2, dtype=torch.float64), target=pt,
        cfg=tw.WalnutsConfig(m=5), device="cpu", **kw)
    _assert_states_match(want[-1], got[-1])
    assert got[0].shape == (12, C, pt.generated_dim) and int(got[3].sum()) > C
    assert got[4] == int(np.asarray(want[-1].grad_ct).sum())
    for a, b in zip(want[:4], got[:4]):
        assert_parity(np.asarray(a), b.numpy(), EXACT)


@pytest.mark.parametrize("key_seed", [0, 5, 11, 12, 2 ** 31 + 3])
def test_key_hash_seed_is_jaxs_derivation(key_seed):
    """``key_hash_seed(k)`` is the hash seed JAX's fused engine derives
    from ``PRNGKey(k)`` (``megakernel.py:1258-1259``)."""
    from walnuts_tpu_torch.sampler.megakernel import key_hash_seed

    key = jax.random.PRNGKey(key_seed)
    want = int(jax.random.randint(jax.random.fold_in(key, 777), (1,), 0,
                                  2 ** 30, jnp.int32)[0])
    assert key_hash_seed(key_seed) == want
