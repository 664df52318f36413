"""The scan engine, the streaming engine, generic NUTS and the
multinomial sampler on a 2 x 2 ``(chains, dim)`` mesh of gloo ranks, and
the last three with their chains split over two ranks, against JAX's
one-device runs: the port of
``test_mesh2_dim_sharded_matches_single_device``
(``tests/test_parallel_and_diagnostics.py``) at JAX's sizes and horizon,
funnel(11) split 6 + 5 through every scan-engine integrator and the
implicit midpoint's Newton mode, a diagonal metric, a target on the
gather route, a target's own generated quantities, pooled warmup over
both chain rows, the streaming engine under both draws, generic NUTS
with both step kernels, the multinomial sampler with and without WASPS
on a ``[D]`` scale, the one engine that raises on the mesh, and the
threefry column window.

A dim split sums over D in another order (each rank its block, then an
all-reduce), so runs without adaptation are held to ``EXACT`` and runs
that adapt to ``ADAPTIVE`` (``walnuts_tpu_torch.utils.parity``).  One
group of four ranks (``tests/torch_rank_jobs.py``) runs every case for
the whole module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_jobs
import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu_torch import parallel
from walnuts_tpu_torch.utils import threefry
from walnuts_tpu_torch.utils.parity import (ADAPTIVE, ENERGY_RANGE,
                                            ENERGY_RANGE_COL, EXACT,
                                            assert_parity)

torch.set_num_threads(2)

RANK_TIMEOUT = 300.0
INT_COLS = [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22]
FLOAT_COLS = [i for i in range(24) if i not in INT_COLS]
# every scan-engine integrator; the implicit midpoint runs its
# fixed-point solve here and its Newton mode in the "newton" cases
INTEGRATORS = sorted(tw.ops.INTEGRATORS)
# the generic-NUTS diagnostics that are integers (DIAG_COLS)
GENERIC_INT_COLS = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]
# the multinomial diagnostics that are integers (DIAG_COLS)
MULTI_INT_COLS = [1, 2, 3, 4, 6, 9]

_rng = np.random.default_rng(21)
JAX_CASE = dict(target=("std_gauss", 8), q0=np.asarray(jax.random.normal(
    jax.random.PRNGKey(0), (8, 8), jnp.float64)), seed=1, m=4,
    integrator="adapt_leapfrog_r2p", warmup_iter=5, pooled=False,
    num_iter=10, h0=0.5, delta0=0.1)
FIXED = dict(seed=3, m=4, integrator="adapt_leapfrog_r2p", warmup_iter=0,
             pooled=False, num_iter=5, h0=0.4, delta0=0.15)
SCAN = {
    "jax_case": JAX_CASE,
    "pooled": dict(JAX_CASE, pooled=True),
    **{f"funnel_{i}": dict(FIXED, target=("funnel", 11), integrator=i,
                           q0=0.5 * np.random.default_rng(3).normal(
                               size=(8, 11)))
       for i in INTEGRATORS},
    "inv_mass": dict(FIXED, target=("ill_conditioned_gauss", 9),
                     q0=_rng.normal(size=(8, 9)),
                     inv_mass=np.linspace(0.5, 2.0, 9)),
    "smile": dict(FIXED, target=("smile",), q0=_rng.normal(size=(8, 2))),
    "radius": dict(FIXED, target=("std_gauss_radius", 7), orbit=True,
                   q0=_rng.normal(size=(8, 7))),
    # a dense Hessian per chain and fixed-point iteration: 2 transitions
    **{name: dict(FIXED, target=("funnel", 11), newton=True, num_iter=2,
                  integrator="adapt_implicit_midpoint_d",
                  q0=0.5 * np.random.default_rng(3).normal(size=(8, 11)),
                  **extra)
       for name, extra in (("newton", {}), ("newton_inv_mass", dict(
           inv_mass=np.linspace(0.6, 1.5, 11))))},
}
PART_B = {
    **{f"streaming_{r}": dict(kind="streaming", rng=r, target=("funnel", 6),
                              q0=0.5 * _rng.normal(size=(8, 6)),
                              h=np.linspace(0.25, 0.6, 8),
                              delta=np.linspace(0.08, 0.3, 8), seed=3, m=5,
                              num_iter=8)
       for r in ("hash", "global")},
    "generic": dict(kind="generic", target=("std_gauss", 5),
                    q0=0.8 * _rng.normal(size=(8, 5)), h=0.5, delta=0.1,
                    seed=11, m=5, num_iter=8),
    "multinomial": dict(kind="multinomial", target=("std_gauss", 5),
                        q0=0.8 * _rng.normal(size=(8, 5)), h=0.6, delta=0.2,
                        seed=17, l_orbit=12, num_iter=14, warmup_iter=12),
}


# the engines besides the scan engine on the 2 x 2 mesh: 8 chains, each
# rank 4 chains and its columns (funnel(11) 6 + 5, std_gauss(5) 3 + 2,
# smile 1 + 1)
_drng = np.random.default_rng(34)
DIM_B = {
    **{f"streaming_{r}": dict(kind="streaming", rng=r, target=("funnel", 11),
                              q0=0.5 * _drng.normal(size=(8, 11)),
                              h=np.linspace(0.25, 0.6, 8),
                              delta=np.linspace(0.08, 0.3, 8), seed=3, m=5,
                              num_iter=6)
       for r in ("hash", "global")},
    **{f"generic_{k}": dict(kind="generic", kernel=k, target=("std_gauss", 5),
                            q0=0.8 * _drng.normal(size=(8, 5)), h=0.5,
                            delta=0.1, seed=11, m=5, num_iter=8)
       for k in ("isokinetic", "hmc")},
    "generic_smile": dict(kind="generic", kernel="isokinetic",
                          target=("smile",), q0=_drng.normal(size=(8, 2)),
                          h=0.4, delta=0.1, seed=5, m=5, num_iter=8),
    **{f"multinomial_{w}": dict(kind="multinomial", target=("std_gauss", 5),
                                wasps=w == "wasps",
                                q0=0.8 * _drng.normal(size=(8, 5)), h=0.6,
                                delta=0.2, seed=17, l_orbit=12, num_iter=14,
                                warmup_iter=12,
                                scale=np.linspace(0.7, 1.3, 5),
                                center=np.linspace(-0.2, 0.2, 5))
       for w in ("wasps", "plain")},
}


@pytest.fixture(scope="module")
def ranks():
    """One run of ``torch_rank_jobs.dim_split`` on a 2 x 2 gloo mesh,
    shared by the tests of this module (rank r is mesh coordinate
    ``(r // 2, r % 2)``)."""
    return parallel.run_ranks(torch_rank_jobs.dim_split, 4,
                              (SCAN, PART_B, DIM_B), timeout=RANK_TIMEOUT,
                              device="cpu")


def _jax_target(spec):
    name, *args = spec
    if name == "std_gauss_radius":
        return wt.targets.std_gauss(*args, generated=lambda q: jnp.stack(
            [q[..., 0], jnp.sum(q * q, axis=-1)], axis=-1))
    return getattr(wt.targets, name)(*args)


def _jax_scan(case):
    inv_mass = case.get("inv_mass")
    orbit = case.get("orbit", False)
    return wt.run_walnuts(
        jax.random.PRNGKey(case["seed"]), jnp.asarray(case["q0"]),
        target=_jax_target(case["target"]),
        cfg=wt.WalnutsConfig(m=case["m"], integrator=case["integrator"],
                             use_inv_mass=inv_mass is not None,
                             record_orbit_stats=orbit,
                             igr=wt.ops.IntegratorConfig(
                                 fp_newton=case.get("newton", False))),
        warmup=wt.WarmupConfig(warmup_iter=case["warmup_iter"],
                               pooled=case["pooled"]),
        num_iter=case["num_iter"], h0=case["h0"], delta0=case["delta0"],
        inv_mass=None if inv_mass is None else jnp.asarray(inv_mass),
        collect_orbit_stats=orbit)


def _assert_scan(want, got, contract):
    """A JAX run against the ranks' joined run: integer diagnostics and
    integer state equal, floats within ``contract`` (column 17 within
    ``ENERGY_RANGE`` under ``ADAPTIVE``)."""
    sj, dj, stj = (np.asarray(x) if i < 2 else x
                   for i, x in enumerate(want[:3]))
    assert_parity(sj, got["samples"], contract, "samples")
    dt = got["diag"]
    np.testing.assert_array_equal(dt[..., INT_COLS], dj[..., INT_COLS])
    cols = [c for c in FLOAT_COLS
            if contract is EXACT or c != ENERGY_RANGE_COL]
    assert_parity(dj[..., cols], dt[..., cols], contract, "diagnostics")
    if contract is not EXACT:
        assert_parity(dj[..., ENERGY_RANGE_COL], dt[..., ENERGY_RANGE_COL],
                      ENERGY_RANGE, "energy range")
    st = got["state"]
    for f in ("q", "lp", "g", "h", "delta", "err_facs"):
        assert_parity(np.asarray(getattr(stj, f)), st[f], contract, f)
    for f in stj.p2._fields:
        assert_parity(np.asarray(getattr(stj.p2, f)), st["p2"][f], contract,
                      f"p2.{f}")
    assert st["iter_n"] == int(stj.iter_n)


def test_jax_case_matches_jax_one_device(ranks):
    """``test_mesh2_dim_sharded_matches_single_device``'s case: std_gauss(8),
    C=8, m=4, 5 warmup and 10 iterations, h0 0.5, delta0 0.1."""
    want = _jax_scan(JAX_CASE)
    for rank in ranks:
        _assert_scan(want, rank["scan"]["jax_case"], ADAPTIVE)
    assert not np.allclose(ranks[0]["scan"]["jax_case"]["state"]["h"], 0.5)


def test_pooled_warmup_over_both_chain_rows(ranks):
    """The pooled median gathers every chain of both chain rows, so the
    whole batch leaves warmup with one H."""
    want = _jax_scan(SCAN["pooled"])
    for rank in ranks:
        got = rank["scan"]["pooled"]
        _assert_scan(want, got, ADAPTIVE)
        assert np.ptp(got["state"]["h"]) == 0 and \
            not np.allclose(got["state"]["h"], 0.5)


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_funnel_split_unevenly_through_every_integrator(ranks, integrator):
    """funnel(11) over two dim ranks (columns 6 + 5), 5 transitions
    without adaptation, within ``EXACT`` of JAX's one device."""
    want = _jax_scan(SCAN[f"funnel_{integrator}"])
    assert ranks[0]["block"] == (0, 6) and ranks[1]["block"] == (6, 11)
    for rank in ranks:
        got = rank["scan"][f"funnel_{integrator}"]
        assert got["width"] == (6 if rank["coords"][1] == 0 else 5)
        _assert_scan(want, got, EXACT)


@pytest.mark.parametrize("case", ["inv_mass", "smile", "radius"])
def test_metric_gather_route_and_own_generated(ranks, case):
    """The diagonal metric on a separable target (ill_conditioned_gauss
    with ``use_inv_mass``), a target on the gather route (``smile``,
    split 1 + 1) and a target's own generated quantities with orbit
    statistics (whole rows on every rank), all within ``EXACT``."""
    want = _jax_scan(SCAN[case])
    for rank in ranks:
        got = rank["scan"][case]
        _assert_scan(want, got, EXACT)
        if case == "radius":
            for w, g, name in zip(want[3:], got["orbit"], ("omin", "omax")):
                assert_parity(np.asarray(w), g, EXACT, name)


@pytest.mark.parametrize("case", ["newton", "newton_inv_mass"])
def test_newton_mode_solves_whole_rows_on_the_dim_split(ranks, case):
    """The implicit midpoint's Newton mode on funnel(11) split 6 + 5,
    with and without a ``[D]`` inverse mass: each rank gathers the
    chains' whole rows and solves the whole system, within ``EXACT`` of
    JAX's one device."""
    want = _jax_scan(SCAN[case])
    for rank in ranks:
        _assert_scan(want, rank["scan"][case], EXACT)


def test_ranks_of_a_dim_group_hold_the_same_rows(ranks):
    """Every per-chain value comes from dim-group collectives, so the two
    ranks that share a chain block hold the same diagnostics rows, bit
    for bit, in every engine (a flag computed on one rank's columns
    alone would have deadlocked the run)."""
    for r0, r1 in ((0, 1), (2, 3)):
        a, b = ranks[r0], ranks[r1]
        assert a["coords"] == (r0 // 2, 0) and b["coords"] == (r0 // 2, 1)
        for name in SCAN:
            assert np.array_equal(a["scan"][name]["diag_local"],
                                  b["scan"][name]["diag_local"]), name
        for name in DIM_B:
            assert np.array_equal(a["dim_b"][name][1],
                                  b["dim_b"][name][1]), name


def test_what_a_dim_split_does_not_take_raises(ranks):
    """Of the engines, only the fused one raises on the 2-D mesh, naming
    its ROADMAP item; the streaming engine, generic NUTS and the
    multinomial sampler run."""
    for rank in ranks:
        err = rank["errors"]
        assert set(err) == {"fused"}
        assert "fused engine and the CUDA round kernel" in err["fused"]
        assert "ROADMAP queue 1 item 4" in err["fused"]


def _jax_part_b(case):
    q0 = jnp.asarray(case["q0"])
    target = _jax_target(case["target"])
    key = jax.random.PRNGKey(case["seed"])
    sp = wt.sampler
    kernel = sp.HMCKernel() if case.get("kernel") == "hmc" \
        else sp.IsokineticKernel()
    if case["kind"] == "streaming":
        return sp.run_walnuts_streaming(
            key, q0, jnp.asarray(case["h"]), jnp.asarray(case["delta"]),
            target=target, cfg=wt.WalnutsConfig(m=case["m"]),
            num_iter=case["num_iter"], rng=case["rng"])
    if case["kind"] == "generic":
        return sp.run_generic_nuts(
            key, q0, target=target, kernel=kernel,
            h_macro=case["h"], delta=case["delta"],
            num_iter=case["num_iter"], m=case["m"])
    s, d, (h, dl) = sp.run_multinomial(
        key, q0, target=target, kernel=kernel,
        cfg=sp.MultinomialConfig(l_orbit=case["l_orbit"],
                                 wasps=case.get("wasps", True)),
        h0=case["h"], delta0=case["delta"], num_iter=case["num_iter"],
        warmup_iter=case["warmup_iter"],
        scale=jnp.asarray(case.get("scale", 1.0)),
        center=jnp.asarray(case.get("center", 0.0)))
    return s, d, h, dl


@pytest.mark.parametrize("name", sorted(PART_B))
def test_chain_split_streaming_and_isokinetic_match_jax(ranks, name):
    """Part of the batch on each of two ranks, every draw keyed by the
    global chain: the joined outputs within ``EXACT`` of JAX's one
    device (the multinomial sampler adapts each chain on its own through
    12 warmup iterations)."""
    want = [np.asarray(x) for x in _jax_part_b(PART_B[name])]
    for rank in ranks:
        got = rank["part_b"][name]
        assert len(got) == len(want)
        for i, (w, g) in enumerate(zip(want, got)):
            assert_parity(w, g, EXACT, f"{name} output {i}")


@pytest.mark.parametrize("name", sorted(DIM_B))
def test_dim_split_streaming_and_isokinetic_match_jax(ranks, name):
    """Each rank its chains and its columns, every sum over D reduced
    over the dim group: the joined outputs against JAX's one device,
    integer diagnostics equal, floats within ``EXACT`` (the multinomial
    sampler, which adapts each chain through 12 warmup iterations,
    within ``ADAPTIVE``)."""
    case = DIM_B[name]
    want = [np.asarray(x) for x in _jax_part_b(case)]
    contract = ADAPTIVE if case.get("warmup_iter") else EXACT
    int_cols = {"streaming": INT_COLS, "generic": GENERIC_INT_COLS,
                "multinomial": MULTI_INT_COLS}[case["kind"]]
    for rank in ranks:
        got = rank["dim_b"][name][0]
        assert len(got) == len(want)
        np.testing.assert_array_equal(got[1][..., int_cols],
                                      want[1][..., int_cols])
        for i, (w, g) in enumerate(zip(want, got)):
            assert_parity(w, g, contract, f"{name} output {i}")


# draws whose last axis a rank may hold a window of: the momentum (C, D)
# and the WASPS directions; windows of uneven blocks (11 = 6 + 5 = 4 +
# 4 + 3) with and without a row window
COL_WINDOW_CASES = {
    "bits32": lambda k, s, r, c: threefry.random_bits(k, 32, s, r, c),
    "uniform f64": lambda k, s, r, c: threefry.uniform(
        k, s, torch.float64, rows=r, cols=c),
    "bernoulli": lambda k, s, r, c: threefry.bernoulli(
        k, 0.5, s, rows=r, cols=c),
    "normal f32": lambda k, s, r, c: threefry.normal(
        k, s, torch.float32, r, c),
    "normal f64": lambda k, s, r, c: threefry.normal(
        k, s, torch.float64, r, c),
}


def _bits(x):
    return x.view(torch.int64) if x.dtype == torch.float64 else x


@pytest.mark.parametrize("case", sorted(COL_WINDOW_CASES))
def test_threefry_column_window_is_the_full_draws_block(case):
    fn = COL_WINDOW_CASES[case]
    keys = threefry.split(threefry.PRNGKey(42), 3)      # a batch of keys
    for shape in ((9, 11), (4, 3, 11)):
        full = fn(keys, shape, None, None)
        half = shape[0] // 2
        for rows in (None, (0, half), (half, shape[0]), (1, 1)):
            for cols in ((0, 6), (6, 11), (0, 4), (4, 8), (8, 11), (3, 3)):
                got = fn(keys, shape, rows, cols)
                r0, r1 = rows or (0, shape[0])
                want = full[:, r0:r1, ..., cols[0]:cols[1]]
                assert got.shape == want.shape, (rows, cols)
                assert torch.equal(_bits(got), _bits(want)), (rows, cols)
    with pytest.raises(ValueError, match="outside the last axis"):
        fn(keys, (9, 11), None, (4, 12))
    with pytest.raises(ValueError, match="two axes or more"):
        fn(keys, (9,), None, (0, 3))


def test_threefry_randint_row_window():
    """The multinomial sampler's forward split, by rows."""
    key = threefry.PRNGKey(17)
    for dtype in (torch.int32, torch.int64):
        full = threefry.randint(key, (10,), 0, 12, dtype)
        want = np.asarray(jax.random.randint(
            jax.random.PRNGKey(17), (10,), 0, 12,
            jnp.int32 if dtype == torch.int32 else jnp.int64))
        assert np.array_equal(full.numpy(), want)
        for r0, r1 in ((0, 5), (5, 10), (3, 7)):
            assert torch.equal(threefry.randint(key, (10,), 0, 12, dtype,
                                                rows=(r0, r1)), full[r0:r1])


def test_dim_block_and_uneven_placement():
    """Column blocks of ``ceil(D / n)``, the last one shorter."""
    assert [parallel.mesh._col_block(101, 2, i) for i in range(2)] == [
        (0, 51), (51, 101)]
    assert [parallel.mesh._col_block(11, 3, i) for i in range(3)] == [
        (0, 4), (4, 8), (8, 11)]
    with pytest.raises(ValueError, match="without a column"):
        parallel.mesh._col_block(5, 4, 0)
