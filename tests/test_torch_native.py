"""The port's loader of the native C++ engine (``walnuts_tpu_torch.native``)
against the JAX package's (``walnuts_tpu.native``): the same source and
flags, so the same draws bit for bit; and the builds-and-samples,
funnel-tail and leapfrog-bench tests of ``tests/test_native.py``.
Skipped without a C++ toolchain, as that file is."""

import shutil

import numpy as np
import pytest

from walnuts_tpu import native as jax_native
from walnuts_tpu_torch import native


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")


@pytest.mark.parametrize("target,dim", [("std_gauss", 10), ("funnel", 11),
                                        ("corr_gauss", 2)])
def test_native_run_equals_the_jax_loader_bit_for_bit(gxx, target, dim):
    assert set(native.TARGET_IDS) == set(jax_native.TARGET_IDS)
    assert native.TARGET_IDS[target] == jax_native.TARGET_IDS[target]
    q0 = 0.3 * np.random.default_rng(dim).normal(size=dim)
    kw = dict(h0=0.4, delta=0.2, m=7, seed=dim + 1, want_diag=True)
    d1, n1, g1 = jax_native.run(target, dim, q0, 400, **kw)
    d2, n2, g2 = native.run(target, dim, q0, 400, **kw)
    assert n2 == n1 > 0
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_array_equal(g2, g1)
    assert g2.shape == (400, 6)
    # multinomial NUTS (adaptive=False) and the two-value return
    d1, n1 = jax_native.run(target, dim, q0, 200, adaptive=False, seed=3)
    d2, n2 = native.run(target, dim, q0, 200, adaptive=False, seed=3)
    assert n2 == n1
    np.testing.assert_array_equal(d2, d1)


def test_native_builds_only_under_the_port_build_dir(gxx):
    path = native.build()
    assert path.parent == native.BUILD
    assert path.parent.name == "build" and \
        path.parent.parent.name == "walnuts_tpu_torch"
    assert path.name.startswith("walnuts_native_") and path.exists()


def test_native_builds_and_samples_gaussian(gxx):
    draws, ng = native.run("std_gauss", 10, np.zeros(10), 3000,
                           h0=0.5, delta=0.1, m=8, seed=1)
    s = draws[300:]
    assert ng > 0
    n_eff = len(s) / 5
    assert abs(s.mean()) < 5 / np.sqrt(n_eff * 10)
    assert abs(s.std() - 1.0) < 0.05


def test_native_funnel_tail(gxx):
    draws, ng = native.run("funnel", 11, np.zeros(11), 6000,
                           h0=0.3, delta=0.3, m=10, seed=2)
    w = draws[1000:, 0]
    assert abs(w.std() - 3.0) < 0.35
    # WALNUTS resolves the tail: left-tail mass near the exact 0.159
    assert (w < -3.0).mean() > 0.10


def test_native_leapfrog_bench_runs(gxx):
    assert native.leapfrog_bench("std_gauss", 50, 100_000, h=0.01) == 100_000
