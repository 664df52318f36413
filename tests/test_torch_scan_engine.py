"""The port's scan engine (``tw.run_walnuts``, ``walnuts_transition``,
checkpoints) against the JAX package's on the CPU, on the same
numpy-seeded inputs and the same threefry keys.  Float64 runs hold the
parity contracts of ``walnuts_tpu_torch.utils.parity``: ``EXACT`` without
adaptation, ``ADAPTIVE`` with warmup; integer diagnostics always equal.
One float32 case is held statistically tighter than its draws' spread."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw
from walnuts_tpu.utils.checkpoint import save_state as jax_save_state
from walnuts_tpu_torch.sampler.driver import (sampler_state_from_numpy,
                                              sampler_state_to_numpy)
from walnuts_tpu_torch.utils.checkpoint import load_state, save_state
from walnuts_tpu_torch.utils.parity import (ADAPTIVE, ENERGY_RANGE,
                                            ENERGY_RANGE_COL, EXACT,
                                            assert_parity)

torch.set_num_threads(2)

C, D, M = 16, 5, 5
Q0 = 0.5 * np.random.default_rng(0).normal(size=(C, D))
# integer-valued diagnostic columns: selected index, doublings, orbit
# extents, gradient counts, If range, passive flags, stop code, depth,
# refinement range
INT_COLS = [0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 19, 20, 21, 22]
FLOAT_COLS = [i for i in range(24) if i not in INT_COLS]


def _jax_run(integrator="adapt_leapfrog_r2p", warmup_iter=0, pooled=False,
             num_iter=20, dtype=np.float64, seed=3, **kw):
    return wt.run_walnuts(
        jax.random.PRNGKey(seed), jnp.asarray(Q0.astype(dtype)),
        target=wt.targets.funnel(D),
        cfg=wt.WalnutsConfig(m=M, integrator=integrator),
        warmup=wt.WarmupConfig(warmup_iter=warmup_iter, pooled=pooled),
        num_iter=num_iter, h0=0.4, delta0=0.15, **kw)


def _port_run(integrator="adapt_leapfrog_r2p", warmup_iter=0, pooled=False,
              num_iter=20, dtype=np.float64, seed=3, **kw):
    return tw.run_walnuts(
        seed, Q0.astype(dtype), target=tw.targets.funnel(D),
        cfg=tw.WalnutsConfig(m=M, integrator=integrator),
        warmup=tw.WarmupConfig(warmup_iter=warmup_iter, pooled=pooled),
        num_iter=num_iter, h0=0.4, delta0=0.15, device="cpu", **kw)


def _assert_run(want, got, contract):
    (sj, dj, stj), (st, dt, stt) = want, got
    assert_parity(np.asarray(sj), st.numpy(), contract, "samples")
    dj, dt = np.asarray(dj), dt.numpy()
    np.testing.assert_array_equal(dt[..., INT_COLS], dj[..., INT_COLS])
    cols = [c for c in FLOAT_COLS
            if contract is EXACT or c != ENERGY_RANGE_COL]
    assert_parity(dj[..., cols], dt[..., cols], contract, "diagnostics")
    if contract is not EXACT:
        assert_parity(dj[..., ENERGY_RANGE_COL], dt[..., ENERGY_RANGE_COL],
                      ENERGY_RANGE, "energy range")
    want_st = {f: np.asarray(v) for f, v in stj._asdict().items()
               if f != "p2"}
    got_st = sampler_state_to_numpy(stt)
    for f, a in want_st.items():
        assert_parity(a, got_st[f], contract, f)
    for f in stj.p2._fields:
        assert_parity(np.asarray(getattr(stj.p2, f)), got_st["p2"][f],
                      contract, f"p2.{f}")
    assert int(stt.iter_n) == int(stj.iter_n)


def test_transition_matches_jax():
    """One ``walnuts_transition`` at fixed (H, delta), with the P2 push."""
    key = jax.random.PRNGKey(11)
    jt, tt = wt.targets.funnel(D), tw.targets.funnel(D)
    h = np.full(C, 0.35)
    delta = np.full(C, 0.12)
    for integrator, warm in (("adapt_leapfrog_r2p", True),
                             ("adapt_leapfrog_d", False)):
        jq = jnp.asarray(Q0)
        jlp, jg = jt.logp_grad(jq)
        want = wt.walnuts_transition(
            key, jq, jlp, jg, jnp.asarray(h), jnp.asarray(delta),
            wt.utils.p2.p2_init(0.2, (C,), jnp.float64), jnp.asarray(warm),
            target=jt, cfg=wt.WalnutsConfig(m=M, integrator=integrator))
        tq = torch.from_numpy(Q0)
        tlp, tg = tt.logp_grad(tq)
        got = tw.sampler.walnuts_transition(
            tw.utils.threefry.PRNGKey(11), tq, tlp, tg, torch.from_numpy(h),
            torch.from_numpy(delta),
            tw.utils.p2_init(0.2, (C,), torch.float64), warm,
            target=tt, cfg=tw.WalnutsConfig(m=M, integrator=integrator))
        dj, dt = np.asarray(want.diagnostics), got.diagnostics.numpy()
        np.testing.assert_array_equal(dt[:, INT_COLS], dj[:, INT_COLS])
        assert_parity(dj[:, FLOAT_COLS], dt[:, FLOAT_COLS], EXACT, "diag")
        for f in ("q", "lp", "g"):
            assert_parity(np.asarray(getattr(want, f)),
                          getattr(got, f).numpy(), EXACT, f)
        for f in want.p2._fields:
            assert_parity(np.asarray(getattr(want.p2, f)),
                          getattr(got.p2, f).numpy(), EXACT, f"p2.{f}")
        assert dj[:, 20].max() >= 2           # orbits doubled
        # one P2 push per computed macro step, in warmup only
        assert bool((got.p2.npush > 0).all()) == warm


@pytest.mark.parametrize("integrator", [
    "adapt_leapfrog_r2p", "adapt_leapfrog_d", "fixed_leapfrog"])
def test_run_without_warmup_exact(integrator):
    _assert_run(_jax_run(integrator), _port_run(integrator), EXACT)


@pytest.mark.parametrize("pooled,seed", [
    pytest.param(False, 2, id="False"), pytest.param(True, 2, id="True"),
    pytest.param(False, 3, id="False-closest-key")])
def test_run_with_warmup_adaptive_contract(pooled, seed):
    """warmup_iter=15 of 25 iterations: delta adapts from iteration 11,
    H once the P2 estimator has 11 pushes.  Samples at 0.22 of the
    adaptive bound under PRNGKey(2) per-chain and at 0.97 under
    PRNGKey(3), the closest of PRNGKey(1..8) that holds it; the energy
    range column within 0.67 of ``ENERGY_RANGE`` (``utils/parity.py``)."""
    kw = dict(warmup_iter=15, pooled=pooled, num_iter=25, seed=seed)
    want = _jax_run(**kw)
    got = _port_run(**kw)
    _assert_run(want, got, ADAPTIVE)
    h = got[2].h.numpy()
    assert not np.allclose(h, 0.4)                    # H adapted
    assert (np.ptp(h) == 0) == pooled                 # one consensus H


def test_per_chain_warmup_drift_grows_past_the_adaptive_contract():
    """``ADAPTIVE`` is a short-horizon contract.  Under PRNGKey(7) with
    per-chain warmup the adapted H and delta agree to ~1e-12 relative
    and every integer diagnostic is equal, yet one chain amplifies the H
    difference ~3x per iteration from iteration 21: its samples hold the
    bound through iteration 20 and pass it at iteration 25."""
    kw = dict(warmup_iter=15, num_iter=25, seed=7)
    (sj, dj, stj), (st, dt, stt) = _jax_run(**kw), _port_run(**kw)
    np.testing.assert_array_equal(dt.numpy()[..., INT_COLS],
                                  np.asarray(dj)[..., INT_COLS])
    for f in ("h", "delta"):
        assert_parity(np.asarray(getattr(stj, f)), getattr(stt, f).numpy(),
                      ADAPTIVE, f)
    sj, st = np.asarray(sj), st.numpy()
    assert_parity(sj[:21], st[:21], ADAPTIVE, "samples to iteration 20")
    bound = ADAPTIVE["atol"] + ADAPTIVE["rtol"] * np.abs(sj[-1])
    assert np.max(np.abs(st[-1] - sj[-1]) / bound) > 1.0


def test_float32_run_statistical():
    """float32, R2P, 20 iterations, no warmup.  Integer diagnostic
    columns equal on at least 99% of chain-iterations (measured: 100%);
    samples within rtol 1e-4 / atol 1e-4 (measured: 8.6e-6 max abs),
    the float diagnostics within 1e-3 (measured: 2.0e-5, in the energy
    range column, a difference of energies; the others equal)."""
    want = _jax_run(dtype=np.float32)
    got = _port_run(dtype=np.float32)
    sj, dj = np.asarray(want[0]), np.asarray(want[1])
    st, dt = got[0].numpy(), got[1].numpy()
    assert st.dtype == np.float32 and dt.dtype == np.float32
    same = np.all(dt[..., INT_COLS] == dj[..., INT_COLS], axis=-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dt[..., FLOAT_COLS], dj[..., FLOAT_COLS],
                               rtol=1e-3, atol=1e-3)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX ``save_state`` file, loaded by the port, resumes to JAX's
    own resumed result (``tests/test_checkpoint.py``'s split run)."""
    key = jax.random.PRNGKey(1)
    jt = wt.targets.std_gauss(D)
    q0 = np.random.default_rng(4).normal(size=(8, D))
    cfg_j, wu_j = wt.WalnutsConfig(m=4), wt.WarmupConfig(warmup_iter=20)
    _, _, st1 = wt.run_walnuts(key, jnp.asarray(q0), target=jt, cfg=cfg_j,
                               warmup=wu_j, num_iter=25, h0=0.5, delta0=0.1)
    path = str(tmp_path / "ckpt.npz")
    jax_save_state(path, st1)
    want = wt.run_walnuts(key, jnp.asarray(q0), target=jt, cfg=cfg_j,
                          warmup=wu_j, num_iter=15, resume_state=st1)

    loaded = load_state(path)
    assert loaded.iter_n == 25 and loaded.q.dtype == torch.float64
    got = tw.run_walnuts(1, None, target=tw.targets.std_gauss(D),
                         cfg=tw.WalnutsConfig(m=4),
                         warmup=tw.WarmupConfig(warmup_iter=20), num_iter=15,
                         resume_state=loaded, device="cpu")
    _assert_run(want, got, ADAPTIVE)
    assert got[2].iter_n == 40

    # the port's own file holds the same twelve arrays, JAX's leaf order
    path2 = str(tmp_path / "port.npz")
    save_state(path2, loaded)
    with np.load(path) as a, np.load(path2) as b:
        assert a.files == b.files and len(a.files) == 12
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])
            assert b[k].dtype == a[k].dtype
    # and the numpy carry-over gives the same state
    st = sampler_state_from_numpy(st1)
    np.testing.assert_array_equal(st.err_facs.numpy(),
                                  np.asarray(st1.err_facs))


def test_entry_points_default_to_the_card():
    """Every public entry runs on ``cuda`` unless the caller passes
    ``device="cpu"``; without a card the default raises."""
    for fn in (tw.run_walnuts, tw.sampler.run_walnuts_fused):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    kw = dict(target=tw.targets.std_gauss(3), num_iter=1,
              cfg=tw.WalnutsConfig(m=2))
    q0 = np.zeros((2, 3))
    assert tw.utils.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        s, _, _ = tw.run_walnuts(0, q0, **kw)
        assert s.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tw.run_walnuts(0, q0, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tw.sampler.run_walnuts_fused(0, q0, 0.1, 0.1, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tw.sampler.run_walnuts_fused_plain(0, q0, 0.1, 0.1, **kw)
    s, _, _ = tw.run_walnuts(0, q0, device="cpu", **kw)
    assert s.device.type == "cpu"


def test_to_device_moves_a_tree_only_when_it_lies_elsewhere():
    """A resume state already on the device is passed through without a
    walk; one elsewhere has every tensor moved and its other leaves kept."""
    from walnuts_tpu_torch.sampler.driver import init_state
    from walnuts_tpu_torch.utils.device import to_device

    st = init_state(tw.targets.std_gauss(3), torch.zeros(2, 3), 0.1, 0.1,
                    tw.WarmupConfig())
    assert to_device(st, torch.device("cpu")) is st
    moved = to_device(st, torch.device("meta"))
    assert moved.q.device.type == "meta" and moved.p2.q.device.type == "meta"
    assert moved.iter_n == st.iter_n
    assert to_device(0.3, torch.device("meta")) == 0.3


def _ratio(want, got, contract):
    """Worst ``|got - want|`` as a share of ``contract``'s bound."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.nanmax(np.abs(got - want)
                           / (contract["atol"] + contract["rtol"]
                              * np.abs(want))))


def drift_survey(seeds=range(1, 9)):
    """The warmup runs of ``test_run_with_warmup_adaptive_contract`` over
    ``PRNGKey(seeds)``, per-chain and pooled: whether the integer
    diagnostics are equal, and the worst float difference of the
    samples, the state and the energy-range column as shares of their
    contracts.  ``PYTHONPATH=. python tests/test_torch_scan_engine.py``
    prints it from the repository root."""
    jax.config.update("jax_enable_x64", True)
    for pooled in (False, True):
        for seed in seeds:
            kw = dict(warmup_iter=15, pooled=pooled, num_iter=25, seed=seed)
            (sj, dj, stj), (st, dt, stt) = _jax_run(**kw), _port_run(**kw)
            dj, dt = np.asarray(dj), dt.numpy()
            got_st = sampler_state_to_numpy(stt)
            state = {f: _ratio(v, got_st[f], ADAPTIVE)
                     for f, v in stj._asdict().items()
                     if f not in ("p2", "iter_n")}
            print(f"pooled={pooled} PRNGKey({seed}): integers equal "
                  f"{np.array_equal(dj[..., INT_COLS], dt[..., INT_COLS])}; "
                  f"samples {_ratio(sj, st.numpy(), ADAPTIVE):.3f}, state "
                  f"{ {f: round(r, 3) for f, r in state.items()} }, column "
                  f"{ENERGY_RANGE_COL} "
                  f"{_ratio(dj[..., ENERGY_RANGE_COL], dt[..., ENERGY_RANGE_COL], ENERGY_RANGE):.3f}"
                  " of their contracts", flush=True)


if __name__ == "__main__":
    drift_survey()
