"""The port's fixed-orbit multinomial sampler
(``tw.sampler.run_multinomial``) and dual averaging against the JAX
package's on the CPU, in float64 with x64 on.  Warmup adapts ``(h,
delta)``, so whole runs are held to the ``ADAPTIVE`` contract of
``walnuts_tpu_torch.utils.parity`` (integer columns equal); dual
averaging alone is held to ``EXACT``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.utils import dual_average as jda
from walnuts_tpu_torch.utils import dual_average as tda
from walnuts_tpu_torch.utils.parity import ADAPTIVE, EXACT, assert_parity

torch.set_num_threads(2)

C, D, L, WARM, N = 8, 5, 12, 20, 30
KERNELS = {"iso": lambda m: m.IsokineticKernel(),
           "hmc": lambda m: m.HMCKernel()}
# integer-valued columns: numForw, sampleIndex, deF, deB, nSteps,
# gradEvals
INT_COLS = [1, 2, 3, 4, 6, 9]
CASES = [(k, w) for k in KERNELS for w in (True, False)]


@pytest.fixture(scope="module")
def q0():
    return 0.8 * np.random.default_rng(3).normal(size=(C, D))


@pytest.mark.parametrize("kname,wasps", CASES)
def test_run_multinomial_matches_jax(q0, kname, wasps):
    kw = dict(h0=0.6, delta0=0.2, num_iter=N, warmup_iter=WARM)
    sj, dj, (hj, dlj) = wt.sampler.run_multinomial(
        jax.random.PRNGKey(17), jnp.asarray(q0),
        target=wt.targets.std_gauss(D),
        kernel=KERNELS[kname](wt.sampler),
        cfg=wt.sampler.MultinomialConfig(l_orbit=L, wasps=wasps), **kw)
    st, dt, (ht, dlt) = tw.sampler.run_multinomial(
        17, q0, target=tw.targets.std_gauss(D),
        kernel=KERNELS[kname](tw.sampler),
        cfg=tw.sampler.MultinomialConfig(l_orbit=L, wasps=wasps),
        device="cpu", **kw)
    dj, dt = np.asarray(dj), dt.numpy()
    assert dt.shape == (N, C, len(tw.sampler.multinomial.DIAG_COLS))
    np.testing.assert_array_equal(dt[..., INT_COLS], dj[..., INT_COLS])
    assert_parity(dj, dt, ADAPTIVE, "diagnostics")
    assert_parity(np.asarray(sj), st.numpy(), ADAPTIVE, "samples")
    assert_parity(np.asarray(hj), ht.numpy(), ADAPTIVE, "h")
    assert_parity(np.asarray(dlj), dlt.numpy(), ADAPTIVE, "delta")
    # warmup moved (h, delta); with WASPS on, some sweeps stopped short
    assert not np.allclose(dt[-1, :, 0], 0.6)
    if wasps:
        assert (dt[..., 6] < L - 1).any()


def test_scaled_coordinates_and_orbit_stats_match_jax():
    """Per-coordinate pre-scaling, a centre and whole-orbit statistics
    on an ill-conditioned Gaussian."""
    q = np.random.default_rng(4).normal(size=(6, 4))
    scale = np.sqrt(np.logspace(0.0, 2.0, 4))
    kw = dict(h0=0.5, delta0=0.2, num_iter=12, warmup_iter=6,
              collect_orbit_stats=True)
    want = wt.sampler.run_multinomial(
        jax.random.PRNGKey(7), jnp.asarray(q),
        target=wt.targets.ill_conditioned_gauss(4, 100.0),
        kernel=wt.sampler.HMCKernel(),
        cfg=wt.sampler.MultinomialConfig(l_orbit=8),
        scale=jnp.asarray(scale), center=0.1, **kw)
    got = tw.sampler.run_multinomial(
        7, q, target=tw.targets.ill_conditioned_gauss(4, 100.0),
        kernel=tw.sampler.HMCKernel(),
        cfg=tw.sampler.MultinomialConfig(l_orbit=8), scale=scale,
        center=0.1, device="cpu", **kw)
    for i, (a, b) in enumerate(zip(want[:2] + want[3:], got[:2] + got[3:])):
        assert_parity(np.asarray(a), b.numpy(), ADAPTIVE, f"output {i}")
    for a, b in zip(want[2], got[2]):
        assert_parity(np.asarray(a), b.numpy(), ADAPTIVE, "(h, delta)")


@pytest.mark.parametrize("masked", [False, True])
def test_dual_average_matches_jax(masked):
    rng = np.random.default_rng(9)
    sj = jda.da_init(0.2, 0.9, (6,), jnp.float64)
    st = tda.da_init(0.2, 0.9, (6,), torch.float64)
    for f in sj._fields:
        assert_parity(np.asarray(getattr(sj, f)), getattr(st, f).numpy(),
                      EXACT, f)
    for _ in range(25):
        x = rng.uniform(0.3, 1.0, 6)
        mask = rng.uniform(size=6) < 0.7 if masked else None
        sj = jda.da_observe(sj, jnp.asarray(x),
                            mask=None if mask is None else jnp.asarray(mask))
        st = tda.da_observe(st, torch.from_numpy(x),
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    for f in sj._fields:
        assert_parity(np.asarray(getattr(sj, f)), getattr(st, f).numpy(),
                      EXACT, f)
    assert_parity(np.asarray(jda.da_par(sj)), tda.da_par(st).numpy(), EXACT,
                  "da_par")
