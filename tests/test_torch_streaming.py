"""The port's streaming engine (``tw.sampler.run_walnuts_streaming``)
against the JAX package's on the CPU, in float64 with x64 on, on the
same numpy-seeded inputs and the same seed: samples, all 24 diagnostic
columns and the final positions within the ``EXACT`` contract of
``walnuts_tpu_torch.utils.parity`` (integer columns equal), for three
integrators under both ``rng`` modes.  Then two properties of the port
alone: a chain's hash stream does not depend on the batch, and a run
chunked at ``q_final`` carries on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.sampler.streaming import \
    run_walnuts_streaming as jax_streaming
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

torch.set_num_threads(2)

# integer-valued diagnostic columns (as the scan engine's)
INT_COLS = [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22]
M, N = 5, 12
TARGETS = {"funnel6": lambda m: m.targets.funnel(6),
           "std_gauss5": lambda m: m.targets.std_gauss(5)}
CASES = [("funnel6", i, r)
         for i in ("adapt_leapfrog_r2p", "adapt_leapfrog_d", "fixed_leapfrog")
         for r in ("hash", "global")]
CASES += [("std_gauss5", "adapt_leapfrog_r2p", r) for r in ("hash", "global")]


def _inputs(name, C=12):
    """Per-chain positions, step sizes and tolerances from a seed."""
    D = TARGETS[name](wt).dim
    rng = np.random.default_rng(5)
    return (0.5 * rng.normal(size=(C, D)), np.linspace(0.25, 0.6, C),
            np.linspace(0.08, 0.3, C))


def _port(seed, q0, h, dl, name, integrator="adapt_leapfrog_r2p",
          rng="hash", num_iter=N, stats=None):
    return tw.sampler.run_walnuts_streaming(
        seed, q0, h, dl, target=TARGETS[name](tw),
        cfg=tw.WalnutsConfig(m=M, integrator=integrator), num_iter=num_iter,
        rng=rng, device="cpu", stats=stats)


@pytest.mark.parametrize("name,integrator,rng", CASES)
def test_streaming_matches_jax(name, integrator, rng):
    q0, h, dl = _inputs(name)
    sj, dj, qj = jax_streaming(
        jax.random.PRNGKey(3), jnp.asarray(q0), jnp.asarray(h),
        jnp.asarray(dl), target=TARGETS[name](wt),
        cfg=wt.WalnutsConfig(m=M, integrator=integrator), num_iter=N,
        rng=rng)
    stats = {}
    st, dt, qt = _port(3, q0, h, dl, name, integrator, rng, stats=stats)
    dj, dt = np.asarray(dj), dt.numpy()
    assert dt.shape == (N, len(q0), 24)
    np.testing.assert_array_equal(dt[..., INT_COLS], dj[..., INT_COLS])
    assert_parity(dj, dt, EXACT, "diagnostics")
    assert_parity(np.asarray(sj), st.numpy(), EXACT, "samples")
    assert_parity(np.asarray(qj), qt.numpy(), EXACT, "q_final")
    # every chain finished every transition, in more rounds than the
    # deepest chain's transitions alone would take
    assert (dt[..., 19] != 0).any() and stats["rounds"] > N


def test_hash_stream_is_per_chain():
    """Under ``rng="hash"`` the first 4 chains of a C=8 run replay
    bitwise as a C=4 run (after ``tests/test_streaming.py``)."""
    q0, h, dl = _inputs("funnel6", C=8)
    s8, d8, q8 = _port(5, q0, h, dl, "funnel6", num_iter=20)
    s4, d4, q4 = _port(5, q0[:4], h[:4], dl[:4], "funnel6", num_iter=20)
    assert torch.equal(s8[:, :4], s4) and torch.equal(d8[:, :4], d4)
    assert torch.equal(q8[:4], q4)


def test_chunked_resume_from_q_final():
    """Two chunks, the second started from the first's ``q_final``:
    shapes hold, the chains move across the boundary, and the first
    chunk's last sample is its ``q_final``."""
    q0, h, dl = _inputs("funnel6", C=8)
    s1, d1, qf = _port(1, q0, h, dl, "funnel6", num_iter=10)
    s2, d2, qf2 = _port(2, qf, h, dl, "funnel6", num_iter=10)
    assert s1.shape == (10, 8, 6) and d2.shape == (10, 8, 24)
    assert torch.equal(s1[-1], qf) and torch.equal(s2[-1], qf2)
    assert bool(torch.isfinite(s2).all())
    assert not torch.allclose(qf, qf2)
