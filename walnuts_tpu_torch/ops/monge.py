"""Riemannian Monge-metric integrators (``walnuts_tpu/ops/monge.py``,
reference ``monge/monge.py``).

The Monge metric is ``G = alpha^2 g g^T + diag(m)`` with ``g`` the
score; its inverse applications and determinants have closed forms via
the matrix-determinant lemma, so the integrators need only
Hessian-vector products (``target.hvp``).

* :func:`monge_init`: the cached state ``(q, p, f, g, r, L, v, Hr, Hv,
  Ham)`` with ``Ham = -f + 0.5 log L + 0.5 v^T G v``;
* :func:`monge_int`: the explicit integrator in ``(q, p)`` with a
  running log-Jacobian from four determinant factors per step;
* :func:`monge_ode_rhs` / :func:`monge_int_adapt`: the exact Monge ODE,
  integrated by the adaptive Dormand-Prince 5(4) pair below at rtol and
  atol 1e-10 (the reference uses ``scipy.solve_ivp``, the JAX version
  ``jax.experimental.ode.odeint``);
* :func:`monge_eps_int`: the extended-phase-space explicit symmetric
  composition ``Phi_B Phi_A Phi_C Phi_A Phi_B`` with harmonic coupling
  ``omega`` and the divergence check ``max|q - qt| < h^2`` (unit mass).

Everything is chain-batched ``[C, D]`` and runs on its inputs' device.
"""

from typing import NamedTuple

import torch

from ..utils import threefry


class MongeState(NamedTuple):
    q: torch.Tensor      # [C, D]
    p: torch.Tensor      # [C, D]
    lp: torch.Tensor     # [C]
    g: torch.Tensor      # [C, D]
    r: torch.Tensor      # [C, D]  g / m
    big_l: torch.Tensor  # [C]     L = 1 + alpha^2 r.g
    v: torch.Tensor      # [C, D]  G^{-1} p
    hr: torch.Tensor     # [C, D]  H r
    hv: torch.Tensor     # [C, D]  H v
    ham: torch.Tensor    # [C]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _col(x):
    return x[:, None]


def monge_init(target, q, p, alpha=0.5, m=1.0):
    """Evaluate the full cached state (``state.evalFirst``,
    ``monge.py:76-92``)."""
    lp, g = target.logp_grad(q)
    r = g / m
    big_l = 1.0 + alpha ** 2 * _dot(r, g)
    v = p / m - _col(alpha ** 2 / big_l) * _col(_dot(r, p)) * r
    hr = target.hvp(q, r)
    hv = target.hvp(q, v)
    gv = m * v + alpha ** 2 * _col(_dot(g, v)) * g
    ham = -lp + 0.5 * torch.log(big_l) + 0.5 * _dot(v, gv)
    return MongeState(q, p, lp, g, r, big_l, v, hr, hv, ham)


def monge_flip(s: MongeState):
    return s._replace(p=-s.p, v=-s.v, hv=-s.hv)


def monge_int(target, s: MongeState, h, nstep: int, alpha=0.5, m=1.0):
    """Explicit Monge integrator with running log-Jacobian
    (``mongeInt``, ``monge.py:123-187``).  ``h`` is per-chain ``[C]``.
    Returns ``(state, log_jac)``."""
    a2 = alpha ** 2
    hh = _col(h)
    q, r, g, v, big_l, hv = s.q, s.r, s.g, s.v, s.big_l, s.hv
    phi_grad = -s.g + _col(a2 / s.big_l) * s.hr
    log_jac = -torch.log(s.big_l)
    lp, hr = s.lp, s.hr
    for _ in range(nstep):
        aL = a2 / big_l
        t1 = v - 0.5 * hh * (phi_grad / m
                             - _col(aL) * _col(_dot(r, phi_grad)) * r)
        det0 = 1.0 + 0.5 * h * aL * _dot(r, hv)
        log_jac = log_jac - torch.log(det0)
        vh = t1 - 0.5 * hh * _col(aL / det0) * _col(_dot(hv, t1)) * r

        hvh0 = target.hvp(q, vh)
        det1 = 1.0 - 0.5 * h * aL * _dot(r, hvh0)
        log_jac = log_jac + torch.log(det1)

        q = q + hh * vh
        lp, g = target.logp_grad(q)
        hvh1 = target.hvp(q, vh)
        r = g / m
        big_l = 1.0 + a2 * _dot(r, g)
        aL = a2 / big_l
        det2 = 1.0 + 0.5 * h * aL * _dot(r, hvh1)
        log_jac = log_jac - torch.log(det2)

        hr = target.hvp(q, r)
        phi_grad = -g + _col(aL) * hr
        t1 = vh - 0.5 * hh * (phi_grad / m
                              - _col(aL) * _col(_dot(r, phi_grad)) * r)
        v = t1 - 0.5 * hh * _col(aL / det2) * _col(_dot(hvh1, t1)) * r
        hv = target.hvp(q, v)
        det3 = 1.0 - 0.5 * h * aL * _dot(r, hv)
        log_jac = log_jac + torch.log(det3)
    log_jac = log_jac + torch.log(big_l)

    p = m * v + a2 * _col(_dot(g, v)) * g
    ginv_p = p / m - _col(a2 / big_l) * _col(_dot(r, p)) * r
    ham = -lp + 0.5 * torch.log(big_l) + 0.5 * _dot(p, ginv_p)
    return MongeState(q, p, lp, g, r, big_l, v, hr, hv, ham), log_jac


def monge_ode_rhs(target, q, p, alpha=0.5, m=1.0):
    """Exact Monge ODE right-hand side (``mongeIntAdapt``'s inner
    ``ode``, ``monge.py:100-111``): returns ``(dq, dp)``."""
    a2 = alpha ** 2
    _, g = target.logp_grad(q)
    r = g / m
    big_l = 1.0 + a2 * _dot(r, g)
    v = p / m - _col(a2 / big_l) * _col(_dot(r, p)) * r
    hr = target.hvp(q, r)
    phi_grad = -g + _col(a2 / big_l) * hr
    hv = target.hvp(q, v)
    p_force = phi_grad - a2 * _col(_dot(v, g)) * hv
    return v, -p_force


# Dormand-Prince 5(4) (the ODE is autonomous, so no nodes): the stage
# weights, the last row being the fifth-order solution's, and the
# difference of the fourth-order embedded weights from those.
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200,
         22 / 525, -1 / 40)


def _rms(x):
    return float(torch.sqrt(torch.mean(x * x)))


def monge_int_adapt(target, q0, p0, t_max, alpha=0.5, m=1.0, rtol=1e-10,
                    atol=1e-10):
    """Ground-truth trajectory by adaptive ODE integration (the
    reference's ``solve_ivp`` oracle, ``monge.py:99-118``): Dormand-Prince
    5(4) with one step size for the whole batch, the RMS error norm over
    every coordinate of every chain, scaled by ``atol + rtol max(|y|,
    |y_new|)``, and Hairer's initial step.  Returns ``(q, p)`` at
    ``t_max``; one host read of the error norm per step."""
    def f(y):
        return torch.stack(monge_ode_rhs(target, y[0], y[1], alpha, m))

    y = torch.stack([q0, p0])
    t_max = float(t_max)
    k1 = f(y)
    # Hairer, Norsett and Wanner, Solving ODEs I, II.4
    scale = atol + rtol * y.abs()
    d0, d1 = _rms(y / scale), _rms(k1 / scale)
    h0 = 1e-6 if d0 < 1e-5 or d1 < 1e-5 else 0.01 * d0 / d1
    d2 = _rms((f(y + h0 * k1) - k1) / scale) / h0
    dm = max(d1, d2)
    h1 = max(1e-6, h0 * 1e-3) if dm <= 1e-15 else (0.01 / dm) ** 0.2
    h = min(100 * h0, h1)
    t = 0.0
    while t < t_max:
        h = min(h, t_max - t)
        ks = [k1]
        for i in range(1, 7):
            ks.append(f(y + h * sum(a * k for a, k in zip(_DP_A[i], ks))))
        y_new = y + h * sum(b * k for b, k in zip(_DP_A[6], ks))
        err = h * sum(e * k for e, k in zip(_DP_E, ks))
        ratio = _rms(err / (atol + rtol * torch.maximum(y.abs(),
                                                        y_new.abs())))
        if ratio <= 1.0:
            t = t_max if h >= t_max - t else t + h
            y, k1 = y_new, ks[6]
        h *= min(10.0, max(0.2, 0.9 * ratio ** -0.2)) if ratio > 0 else 10.0
    return y[0], y[1]


def monge_eps_int(target, q, p, qt=None, pt=None, *, key=None, h=0.3,
                  omega=100.0, nstep: int = 1, alpha=0.5):
    """Extended-phase-space integrator (``mongeEPSInt``,
    ``monge.py:209-312``): doubled variables with harmonic coupling,
    symmetric composition B-A-C-A-B; unit mass.  Without ``qt``/``pt``
    the copy is ``(q, p)`` jittered by ``h^2 U(-1, 1)`` from the
    threefry ``key`` (JAX's draws).

    Returns ``(q, p, qt, pt, ok)`` where ``ok`` is the per-chain
    divergence check ``max|q - qt| < h^2 and max|p - pt| < h^2``."""
    a2 = alpha ** 2
    if qt is None:
        if key is None:
            raise ValueError("key required to jitter the phase-space copy")
        k1, k2 = threefry.split(key.to(q.device))
        qt = q + h ** 2 * threefry.uniform(k1, q.shape, q.dtype, -1.0, 1.0)
        pt = p + h ** 2 * threefry.uniform(k2, p.shape, p.dtype, -1.0, 1.0)

    two_wh = torch.tensor(2.0 * omega * h, dtype=q.dtype, device=q.device)
    wt1 = 0.5 * torch.cos(two_wh)
    wt2 = 0.5 * torch.sin(two_wh)

    def phi_b(q, p, qt, pt):
        _, gt = target.logp_grad(qt)
        lt = 1.0 + a2 * _dot(gt, gt)
        tmp1 = a2 * _dot(gt, p) / lt
        q = q + 0.5 * h * (p - _col(tmp1) * gt)
        htgt = target.hvp(qt, gt)
        htp = target.hvp(qt, p)
        pt = pt - 0.5 * h * (-gt + _col(tmp1 ** 2 + a2 / lt) * htgt
                             - _col(tmp1) * htp)
        return q, p, qt, pt

    def phi_a(q, p, qt, pt):
        _, g = target.logp_grad(q)
        l_ = 1.0 + a2 * _dot(g, g)
        tmp1 = a2 * _dot(g, pt) / l_
        qt = qt + 0.5 * h * (pt - _col(tmp1) * g)
        hg = target.hvp(q, g)
        hpt = target.hvp(q, pt)
        p = p - 0.5 * h * (-g + _col(tmp1 ** 2 + a2 / l_) * hg
                           - _col(tmp1) * hpt)
        return q, p, qt, pt

    def phi_c(q, p, qt, pt):
        qbar, pbar = 0.5 * (q + qt), 0.5 * (p + pt)
        dq, dp = q - qt, p - pt
        return (qbar + wt1 * dq + wt2 * dp, pbar + wt1 * dp - wt2 * dq,
                qbar - wt1 * dq - wt2 * dp, pbar - wt1 * dp + wt2 * dq)

    for _ in range(nstep):
        for phi in (phi_b, phi_a, phi_c, phi_a, phi_b):
            q, p, qt, pt = phi(q, p, qt, pt)
    ok = (torch.amax(torch.abs(q - qt), dim=-1) < h ** 2) & (
        torch.amax(torch.abs(p - pt), dim=-1) < h ** 2)
    return q, p, qt, pt, ok


def monge_hamiltonian(target, q, p, alpha=0.5):
    """Marginal Monge Hamiltonian at ``(q, p)`` with unit mass
    (``monge.py:219-222``)."""
    a2 = alpha ** 2
    lp, g = target.logp_grad(q)
    l_ = 1.0 + a2 * _dot(g, g)
    ginv_p = p - _col(a2 / l_) * _col(_dot(g, p)) * g
    return -lp + 0.5 * torch.log(l_) + 0.5 * _dot(p, ginv_p)
