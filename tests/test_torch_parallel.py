"""Chains split over torch.distributed ranks (``walnuts_tpu_torch.parallel``)
against JAX's one-device runs and the port's one-process runs: the ports
of ``test_mesh_sharded_transition_matches_single_device`` and
``test_diagnostics_bitwise_stable_across_shardings``
(``tests/test_parallel_and_diagnostics.py``) at JAX's sizes, the fused
engine over two ranks, the threefry row window, the mesh and placement
errors, and ``entry`` / ``dryrun_multichip``.

The multi-rank cases run in gloo processes on the CPU
(``parallel.run_ranks``) that import only the port
(``tests/torch_rank_jobs.py``), with a timeout of their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_rank_jobs
import walnuts_tpu as wt
from walnuts_tpu.sampler.megakernel import run_walnuts_fused as jax_fused
import walnuts_tpu_torch as tw
from walnuts_tpu_torch import parallel
from walnuts_tpu_torch.diagnostics import ess, rhat, split_rhat
from walnuts_tpu_torch.utils import threefry
from walnuts_tpu_torch.utils.parity import EXACT, assert_parity

torch.set_num_threads(2)

RANK_TIMEOUT = 240.0
# the fused runs' key and the JAX engine's hash seed derivation from it
# (walnuts_tpu/sampler/megakernel.py:1258-1259)
FUSED_KEY = jax.random.PRNGKey(2024)
FUSED_SEED = int(jax.random.randint(jax.random.fold_in(FUSED_KEY, 777), (1,),
                                    0, 2 ** 30, jnp.int32)[0])
FUSED = dict(num_iter=20, stop_mode="per_chain", rounds=160, micro_unroll=2)


@pytest.fixture(scope="module")
def two_ranks():
    """One two-rank run of ``torch_rank_jobs.scan_and_fused``, shared by
    the tests of this module."""
    q_scan = np.array(jax.random.normal(jax.random.PRNGKey(0), (16, 6),
                                        jnp.float64))
    q_fused = 0.3 * np.random.default_rng(5).normal(size=(16, 7))
    draws = np.random.default_rng(11).normal(size=(200, 16, 3))
    ranks = parallel.run_ranks(torch_rank_jobs.scan_and_fused, 2,
                               (q_scan, q_fused, draws, FUSED_SEED),
                               timeout=RANK_TIMEOUT, device="cpu")
    return dict(q_scan=q_scan, q_fused=q_fused, draws=draws, ranks=ranks)


@pytest.fixture(params=["no group", "one-rank group"])
def one_rank(request):
    """No process group, or a one-rank gloo group made here (and taken
    down after the test)."""
    assert not dist.is_initialized()
    if request.param == "one-rank group":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield request.param
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("pooled", [False, True])
def test_chain_split_run_walnuts_matches_jax_one_device(two_ranks, pooled):
    q0 = two_ranks["q_scan"]
    s1, d1, st1 = wt.run_walnuts(
        jax.random.PRNGKey(1), jnp.asarray(q0), target=wt.targets.std_gauss(6),
        cfg=wt.WalnutsConfig(m=4),
        warmup=wt.WarmupConfig(warmup_iter=5, pooled=pooled), num_iter=10,
        h0=0.5, delta0=0.1)
    s2, d2, st2 = tw.run_walnuts(
        1, q0, target=tw.targets.std_gauss(6), cfg=tw.WalnutsConfig(m=4),
        warmup=tw.WarmupConfig(warmup_iter=5, pooled=pooled), num_iter=10,
        h0=0.5, delta0=0.1, device="cpu")
    one = [x.numpy() for x in (s2, d2, st2.h, st2.delta)]
    for rank in two_ranks["ranks"]:
        assert rank["world"] == 2
        got = rank[f"scan_{pooled}"]
        for want, g, name in zip((s1, d1, st1.h, st1.delta), got,
                                 ("samples", "diag", "h", "delta")):
            assert_parity(np.asarray(want), g, EXACT, name)
        # rank r's rows are the one-process run's rows (integers equal,
        # floats within EXACT: torch's CPU vector loops run a tail
        # shorter than two vector widths through the scalar op, whose
        # transcendentals differ from the vector ones in the last bit, so
        # a batch of 8 chains and one of 16 may round apart)
        for want, g, name in zip(one, got, ("samples", "diag", "h", "delta")):
            assert_parity(want, g, EXACT, name)


def test_chain_split_fused_plain_run_matches_jax_and_one_process(
        two_ranks):
    """The fused engine over two ranks (global hash ids, all-reduced stop
    test, gathered consensus), joined in rank order, against JAX's
    one-device ``run_walnuts_fused(rng="hash")`` and the port's one
    process."""
    q0 = two_ranks["q_fused"]
    C = q0.shape[0]
    jx = jax_fused(
        FUSED_KEY, jnp.asarray(q0), jnp.full((C,), 0.4),
        jnp.full((C,), 0.15), target=wt.targets.funnel(7),
        cfg=wt.WalnutsConfig(m=4),
        warmup=wt.WarmupConfig(warmup_iter=20, pooled=True), rng="hash",
        **FUSED)
    res = tw.sampler.run_walnuts_fused_plain(
        FUSED_SEED, q0, np.full(C, 0.4), np.full(C, 0.15),
        target=tw.targets.funnel(7), cfg=tw.WalnutsConfig(m=4),
        warmup=tw.WarmupConfig(warmup_iter=20, pooled=True), device="cpu",
        **FUSED)
    samples, diags, qc, cnt, ng, h, dl = res[:7]
    one = [x.numpy() for x in (samples, diags, qc, cnt, h, dl)]
    jst = jx[-1]
    want = [np.asarray(x) for x in jx[:4] + jx[5:7]]
    assert int(cnt.sum()) > 0 and res[-1].n == 160
    assert int(np.asarray(jst.grad_ct).sum()) == ng
    names = ("samples", "diags", "q_final", "counts", "h", "delta")
    for rank in two_ranks["ranks"]:
        # integers equal, floats within EXACT (against the one process
        # too: the CPU's vector-loop tails, as above; on the card the
        # ranks' rows are bitwise, chip_smoke 10a)
        for w, o, g, name in zip(want, one, rank["fused"], names):
            assert_parity(w, g, EXACT, name)
            assert_parity(o, g, EXACT, name)
        assert rank["fused_grads"] == ng
        assert rank["fused_rounds"] == 160


def test_diagnostics_bitwise_stable_across_ranks(two_ranks):
    draws = torch.from_numpy(two_ranks["draws"])
    want = [f(draws).numpy() for f in (ess, rhat, split_rhat)]
    for rank in two_ranks["ranks"]:
        for w, g, name in zip(want, rank["diag_stats"],
                              ("ess", "rhat", "split_rhat")):
            assert np.array_equal(w, g), (name, w, g)


def test_mesh_and_placement_errors_on_two_ranks(two_ranks):
    for rank in two_ranks["ranks"]:
        err = rank["errors"]
        assert "5 chains do not split evenly over 2 ranks" in err["uneven"]
        assert err["mesh"] == "requested 3 devices, have 2"
        assert err["mesh2"] == "requested 4 devices, have 2"
        assert "ROADMAP" in err["dim_split"]
        assert rank["dim_block"] == (4, 6)


def test_one_rank_mesh_takes_the_single_process_path(one_rank):
    mesh = parallel.make_mesh()
    if one_rank == "no group":   # no mesh, and no group made on the side
        assert mesh is None and parallel.make_mesh2(1, 1) is None
        assert not dist.is_initialized()
    else:
        assert mesh.size() == 1
    assert parallel.chain_block(mesh, 8) == (0, 8)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        parallel.make_mesh(2)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        parallel.make_mesh2(1, 2)
    q0 = np.random.default_rng(2).normal(size=(6, 4))
    assert torch.equal(parallel.shard_chains(q0, mesh), torch.from_numpy(q0))
    assert torch.equal(parallel.replicate(q0, mesh), torch.from_numpy(q0))
    kw = dict(target=tw.targets.std_gauss(4), cfg=tw.WalnutsConfig(m=3),
              warmup=tw.WarmupConfig(warmup_iter=3, pooled=True),
              num_iter=4, h0=0.5, delta0=0.2, device="cpu")
    state = tw.sampler.init_state(kw["target"], torch.from_numpy(q0))
    sharded = parallel.shard_sampler_state(state, mesh)
    assert sharded.iter_n == 0 and torch.equal(sharded.q, state.q)
    a = tw.run_walnuts(3, q0, **kw)
    b = tw.run_walnuts(3, parallel.shard_chains(q0, mesh), mesh=mesh, **kw)
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("device,cards,want", [
    ("cpu", 4, [("cpu", "gloo")] * 2),
    ("cuda", 4, [("cuda:0", "nccl"), ("cuda:1", "nccl")]),
    ("cuda", 1, [("cuda:0", "gloo")] * 2),
    ("cuda:0", 4, [("cuda:0", "gloo")] * 2),
    ("cuda:2", 4, [("cuda:2", "gloo")] * 2),
])
def test_rank_layout_picks_the_backend_from_where_the_ranks_live(
        monkeypatch, device, cards, want):
    """NCCL only for a card per rank; ranks on the CPU or on one shared
    card use gloo, however many cards the host shows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    got = [parallel.rank_layout(device, 2, r) for r in range(2)]
    assert [(str(d), b) for d, b in got] == want


# the draw shapes of one transition (_draws): momentum (C, D), directions
# (C, m), jitter (C, 2), coins and uniforms (C,)
WINDOW_CASES = {
    "bits32 (C, D)": (lambda k, s, r: threefry.random_bits(k, 32, s, r),
                      (9, 5)),
    "bits64 (C,)": (lambda k, s, r: torch.stack(
        threefry.random_bits(k, 64, s, r)), (9,)),
    "uniform f32 (C, 2)": (lambda k, s, r: threefry.uniform(
        k, s, torch.float32, 0.8, 1.2, r), (9, 2)),
    "uniform f64 (C,)": (lambda k, s, r: threefry.uniform(
        k, s, torch.float64, rows=r), (9,)),
    "bernoulli (C, m)": (lambda k, s, r: threefry.bernoulli(
        k, 0.5, s, rows=r), (9, 6)),
    "normal f32 (C, D)": (lambda k, s, r: threefry.normal(
        k, s, torch.float32, r), (9, 5)),
    "normal f64 (C, D)": (lambda k, s, r: threefry.normal(
        k, s, torch.float64, r), (9, 5)),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_threefry_row_window_is_the_full_draws_rows(case):
    fn, shape = WINDOW_CASES[case]
    keys = threefry.split(threefry.PRNGKey(42), 3)       # a batch of keys
    full = fn(keys, shape, None)
    lead = full.ndim - len(shape)          # the key batch (and bits64's 2)
    for r0, r1 in ((0, 9), (0, 4), (4, 9), (3, 7), (8, 9), (5, 5)):
        got = fn(keys, shape, (r0, r1))
        want = full.narrow(lead, r0, r1 - r0)
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int64) if got.dtype ==
                           torch.float64 else got,
                           want.view(torch.int64) if want.dtype ==
                           torch.float64 else want), (r0, r1)
    with pytest.raises(ValueError, match="outside the leading axis"):
        fn(keys, shape, (2, 10))


def test_refresh_momentum_window_is_jax_rows():
    from walnuts_tpu_torch.ops.hamiltonian import refresh_momentum

    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.normal(key, (10, 4), jnp.float64))
    tkey = torch.tensor(np.asarray(key, np.uint32).astype(np.int64))
    full = refresh_momentum(tkey, (10, 4), dtype=torch.float64)
    got = refresh_momentum(tkey, (10, 4), dtype=torch.float64, rows=(6, 10))
    assert torch.equal(got, full[6:])
    np.testing.assert_allclose(got.numpy(), want[6:], rtol=1e-14, atol=0)


def test_entry_on_the_cpu():
    fn, args = tw.entry.entry(device="cpu")
    q, diag = fn(*args)
    assert tuple(q.shape) == (32, 101) and tuple(diag.shape) == (32, 24)
    assert bool(torch.isfinite(q).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tw.entry.entry()


def test_dryrun_multichip_four_ranks():
    report = tw.entry.dryrun_multichip(4, timeout=RANK_TIMEOUT,
                                       device="cpu")
    assert report["ranks"] == 4 and report["rank"] == 0
    assert report["diag"] == (8, 24) and report["counts"] == (8,)
    assert report["draws"] == (4, 8, 7) and report["grads"] > 0
    # the (chains, dim) step over a 2 x 2 mesh, joined over both axes,
    # against the same step in one process (sums over D in another order)
    dim_split = report["dim_split"]
    assert dim_split["block"] == (2, 4)
    assert dim_split["diag"].shape == (4, 24)
    assert_parity(dim_split["one_process"], dim_split["diag"], EXACT,
                  "dim-split diagnostics")
