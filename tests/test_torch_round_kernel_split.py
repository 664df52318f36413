"""The CUDA round kernel's split of a chain over its threads, mirrored in
plain torch on the CPU.

The Stock-Watson instantiation runs one chain over ``32 * WPC`` threads
(``WPC = round_kernel.WARPS_PER_CHAIN["stock_watson"]``): thread ``t``
owns the coordinates ``d = t + 32 WPC j`` of every vector and the series
indices ``SW_CH t + i``, and each of the gradient's six scans is a warp
scan joined over the warps by a prefix (suffix) of their totals in a
fixed order (``Chain::before``, ``Chain::after`` and ``Chain::sums`` in
``csrc/round_kernel.cu``).  :func:`split_logp_grad` follows those steps
thread by thread in float64 and is held against the JAX package's
``stock_watson`` at series lengths whose ends fall in every part of the
split.  The launch geometry the wrapper computes is held for every
instantiation, and against the CUDA source's constants.
"""

import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
from walnuts_tpu.targets.stock_watson import load_sw_data
from walnuts_tpu_torch.sampler import round_kernel as rk

SRC = (Path(__file__).resolve().parents[1] / "walnuts_tpu_torch" / "csrc"
       / "round_kernel.cu").read_text()
WPC = rk.WARPS_PER_CHAIN["stock_watson"]
NT = 32 * WPC                 # threads per chain
SW_CH = rk.SW_TMAX // NT      # series indices per thread
NJ = 3 * rk.SW_TMAX // NT     # trial values per thread
LANE = torch.arange(32)


def _warps(x):
    return x.reshape(WPC, 32)


def _shfl_up(s, o):
    return torch.cat([s[:, :o], s[:, :-o]], dim=1)


def _shfl_down(s, o):
    return torch.cat([s[:, o:], s[:, -o:]], dim=1)


def chain_before(x):
    """Exclusive prefix over the chain's threads: a warp scan (shuffles
    up), then the totals of the warps before, added in order from 0."""
    s = _warps(x)
    for o in (1, 2, 4, 8, 16):
        s = torch.where(LANE >= o, s + _shfl_up(s, o), s)
    tot = s[:, 31]
    e = torch.where(LANE > 0, _shfl_up(s, 1), torch.zeros(()))
    off = [torch.zeros((), dtype=x.dtype)]
    for w in range(1, WPC):
        off.append(off[-1] + tot[w - 1])
    return (torch.stack(off)[:, None] + e).reshape(NT)


def chain_after(x):
    """Exclusive suffix: a warp scan (shuffles down), then the totals of
    the warps after, added in order from the lowest."""
    s = _warps(x)
    for o in (1, 2, 4, 8, 16):
        s = torch.where(LANE + o < 32, s + _shfl_down(s, o), s)
    tot = s[:, 0]
    e = torch.where(LANE < 31, _shfl_down(s, 1), torch.zeros(()))
    off = []
    for w in range(WPC):
        acc = torch.zeros((), dtype=x.dtype)
        for v in range(w + 1, WPC):
            acc = acc + tot[v]
        off.append(acc)
    return (torch.stack(off)[:, None] + e).reshape(NT)


def chain_sum(x):
    """A warp butterfly, then the warps' partials added in order."""
    s = _warps(x)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, LANE ^ o]
    tot = s[0, 0]
    for w in range(1, WPC):
        tot = tot + s[w, 0]
    return tot


def split_logp_grad(q, y, proper):
    """``sw_logp_grad`` of the kernel for one position ``q [3T]``: the
    log density and the gradient, thread by thread."""
    T = y.shape[0]
    zero = torch.zeros((), dtype=q.dtype)
    k = SW_CH * torch.arange(NT)[:, None] + torch.arange(SW_CH)  # [NT, CH]

    def at(off, valid):
        return torch.where(valid, q[(off + k).clamp(max=3 * T - 1)], zero)

    zin, xin = at(2, k < T - 2), at(T + 1, k < T - 1)
    tin = at(2 * T + 1, k < T - 1)
    sig = torch.exp(-0.5 * q[0])
    z1, x1, tau1 = q[1], q[T], q[2 * T]
    # states
    rz, rx = chain_before(zin.sum(1)), chain_before(xin.sum(1))
    z, x, w = [], [], []
    for i in range(SW_CH):
        z.append(z1 + sig * rz)
        x.append(x1 + sig * rx)
        rz, rx = rz + zin[:, i], rx + xin[:, i]
        w.append(torch.where(k[:, i] < T - 1, torch.exp(0.5 * z[i]) * tin[:, i],
                             zero))
    rt = chain_before(sum(w))
    tau = []
    for i in range(SW_CH):
        tau.append(tau1 + rt)
        rt = rt + w[i]
    inn2 = (zin * zin + xin * xin + tin * tin).sum(1)
    # residual terms, then the suffix scans
    yk = torch.where(k < T, y[k.clamp(max=T - 1)], zero)
    a, b, lik = [], [], torch.zeros(NT, dtype=q.dtype)
    for i in range(SW_CH):
        ok = k[:, i] < T
        res = yk[:, i] - tau[i]
        e = torch.exp(-x[i])
        lik = lik + torch.where(ok, res * res * e + x[i], zero)
        a.append(torch.where(ok, 0.5 * res * res * e - 0.5, zero))
        b.append(torch.where(ok, res * e, zero))
    g = torch.zeros(3 * T, dtype=q.dtype)
    ra, rb = chain_after(sum(a)), chain_after(sum(b))
    dx, c = torch.zeros(NT, dtype=q.dtype), [None] * SW_CH
    for i in reversed(range(SW_CH)):
        kk, ok = k[:, i], k[:, i] < T - 1
        g[(T + 1 + kk)[ok]] = (-xin[:, i] + sig * ra)[ok]
        g[(2 * T + 1 + kk)[ok]] = (-tin[:, i]
                                   + torch.exp(0.5 * z[i]) * rb)[ok]
        dx = dx + torch.where(ok, xin[:, i] * ra, zero)
        c[i] = torch.where(ok, 0.5 * torch.exp(0.5 * z[i]) * tin[:, i] * rb,
                           zero)
        ra, rb = ra + a[i], rb + b[i]
    rc = chain_after(sum(c))
    dz = torch.zeros(NT, dtype=q.dtype)
    for i in reversed(range(SW_CH)):
        kk, ok = k[:, i], k[:, i] < T - 2
        g[(2 + kk)[ok]] = (-zin[:, i] + sig * rc)[ok]
        dz = dz + torch.where(ok, zin[:, i] * rc, zero)
        rc = rc + c[i]
    # thread 0's running sums are C_0, A_0, B_0
    g[1] = rc[0] - z1 if proper else rc[0]
    g[T] = ra[0] - x1 if proper else ra[0]
    g[2 * T] = rb[0] - tau1 if proper else rb[0]
    ets = torch.exp(q[0])
    g[0] = 5 - 0.5 * ets - 0.5 * sig * (chain_sum(dz) + chain_sum(dx))
    log2pi = float(np.log(2 * np.pi))
    lp = 5 * q[0] - 0.5 * ets
    if proper:
        lp = lp - 0.5 * (z1 * z1 + x1 * x1 + tau1 * tau1 + 3 * log2pi)
    lp = lp - 0.5 * chain_sum(inn2) - 0.5 * (3 * T - 4) * log2pi
    lp = lp - 0.5 * chain_sum(lik)
    return lp - 0.5 * T * log2pi, g


def _series(tmp_path, T):
    """The repo's 252 quarters, or a numpy-seeded synthetic series."""
    if T == 252:
        return None
    rng = np.random.default_rng(T)
    y = np.cumsum(0.3 * rng.normal(size=T)) + rng.normal(size=T)
    path = tmp_path / f"sw_{T}.json"
    path.write_text(json.dumps({"T": T, "y": y.tolist()}))
    return str(path)


@pytest.mark.parametrize("T", [3, 100, 252, 256])
@pytest.mark.parametrize("proper", [False, True])
def test_split_gradient_matches_jax(tmp_path, T, proper):
    """The kernel's split of Stock-Watson's gradient (each thread two
    series indices, warp scans joined across the four warps) equals the
    JAX target's log density and gradient in float64."""
    path = _series(tmp_path, T)
    tj = wt.targets.stock_watson(path, proper=proper)
    _, y = load_sw_data(path)
    q = 0.3 * np.random.default_rng(T).normal(size=(3, 3 * T))
    lp_j, g_j = (np.asarray(v) for v in tj.logp_grad(jnp.asarray(q)))
    for c in range(q.shape[0]):
        lp, g = split_logp_grad(torch.from_numpy(q[c]), torch.from_numpy(y),
                                proper)
        np.testing.assert_allclose(float(lp), lp_j[c], rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), g_j[c], rtol=1e-10,
                                   atol=1e-12 * np.abs(g_j[c]).max())


@pytest.mark.parametrize("T", [3, 100, 252, 256])
def test_split_owns_every_coordinate_and_index_once(T):
    """Coordinates ``t + NT j`` (j < NJ) below D = 3T and series indices
    ``SW_CH t + i`` below T: each exactly once over the chain's threads,
    and the warp scans see the indices in order."""
    t = torch.arange(NT)[:, None]
    d = (t + NT * torch.arange(NJ)).flatten()
    assert sorted(d[d < 3 * T].tolist()) == list(range(3 * T))
    k = (SW_CH * t + torch.arange(SW_CH)).flatten()
    assert sorted(k[k < T].tolist()) == list(range(T))
    assert k.tolist() == list(range(rk.SW_TMAX))  # thread-major order
    x = torch.arange(NT, dtype=torch.float64) + 1
    want = torch.cumsum(x, 0)
    torch.testing.assert_close(chain_before(x), want - x, rtol=0, atol=0)
    torch.testing.assert_close(chain_after(x), want[-1] - want, rtol=0,
                               atol=0)
    assert float(chain_sum(x)) == float(want[-1])


@pytest.mark.parametrize("target", list(rk.INSTANTIATIONS))
@pytest.mark.parametrize("C", [1, 5, 256, 8192])
def test_launch_geometry(target, C):
    """Four one-warp chains per block of 128 threads, except
    Stock-Watson's one chain per block of four warps."""
    threads, blocks = rk.launch_geometry(target, C)
    if target == "stock_watson":
        assert (threads, blocks) == (128, C)
    else:
        assert (threads, blocks) == (128, -(-C // 4))
    assert threads * blocks >= 32 * rk.WARPS_PER_CHAIN[target] * C


def test_geometry_mirrors_cuda_source():
    """The wrapper's constants are the kernel's."""
    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))

    assert const("THREADS") == rk.THREADS
    assert const("SW_WPC") == WPC
    assert const("SW_TMAX") == rk.SW_TMAX
    assert rk.WARPS_PER_CHAIN.keys() == rk.INSTANTIATIONS.keys()
