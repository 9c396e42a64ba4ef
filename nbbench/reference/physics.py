"""The plain reference: softened all-pairs gravity, its potential and VJP,
and the frame-shifted Verlet step, in plain PyTorch.

Written from the equations, not from the program: the acceleration of body
i is ``G sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps2)^(3/2)`` (the self
pair adds zero), the potential energy ``-G sum_{i<j} m_i m_j /
sqrt(r^2 + eps2)``, and one step of the reference app's frame-shifted
Verlet, with the acceleration of the previous step carried in the state::

    f  = accel(x)
    v' = v + (a + f) dt/2
    x' = x + (v' + f dt/2) dt
    a' = f

Two forms of the pair sum.  ``float64`` (the reference) forms r^2 from one
matrix product, ``|x_i|^2 + |x_j|^2 - 2 x_i.x_j``, and the sum as
``W (m x) - x_i (W m)`` with the self pair left out: in float64 both lose
under 1e-9 of the result at the benchmark's sizes (positions under 20,
eps2 = 1e-4), and the matrix products keep the card's time to some seconds
at N = 262,144.  Any other
dtype (the lower-precision control) takes the differences directly in that
dtype, as a kernel in that precision would.

Everything works on ``(N, 3)`` positions and ``(N,)`` masses of the real
bodies, in blocks of target rows so that the ``(block, N)`` temporaries fit.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _blocks(n: int, block: int):
    for s in range(0, n, block):
        yield s, min(s + block, n)


def default_block(n: int, budget: float = 2.0e8) -> int:
    """Target rows a block, so that a ``(block, n)`` temporary holds about
    ``budget`` elements."""
    return max(1, min(n, int(budget // max(n, 1))))


def accel(x: torch.Tensor, m: torch.Tensor, G: float, eps2: float, *, dtype=F64, block: int | None = None) -> torch.Tensor:
    """``(N, 3)`` accelerations in ``dtype``'s arithmetic, returned as float64."""
    return accel_potential(x, m, G, eps2, dtype=dtype, block=block, potential=False)[0]


def accel_potential(
    x: torch.Tensor, m: torch.Tensor, G: float, eps2: float, *,
    dtype=F64, block: int | None = None, potential: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Accelerations ``(N, 3)`` and, with ``potential``, each body's
    potential ``phi_i = -G sum_{j != i} m_j / sqrt(r^2 + eps2)`` ``(N,)``,
    both float64."""
    n = x.shape[0]
    block = block or default_block(n)
    out = torch.empty(n, 3, dtype=F64, device=x.device)
    phi = torch.empty(n, dtype=F64, device=x.device) if potential else None
    if dtype == F64:
        xd, md = x.to(F64), m.to(F64)
        xd = xd - xd.mean(dim=0)
        sq = (xd * xd).sum(dim=1)
        mx = xd * md[:, None]
        for s, e in _blocks(n, block):
            xb = xd[s:e]
            r2 = torch.addmm(sq[None, :], xb, xd.T, beta=1.0, alpha=-2.0)
            r2.add_(sq[s:e, None] + eps2)
            rs = r2.rsqrt_()
            # The self pair adds nothing; left in, its large w m x_i would
            # cancel against x_i w m and leave rounding behind.
            rs.diagonal(offset=s).zero_()
            if potential:
                phi[s:e] = -G * (rs @ md)
            w = rs.pow_(3)
            out[s:e] = G * (w @ mx - xb * (w @ md)[:, None])
        return out, phi
    xl, ml = x.to(dtype), m.to(dtype)
    for s, e in _blocks(n, block):
        d = xl[None, :, :] - xl[s:e, None, :]
        r2 = (d * d).sum(dim=2) + eps2
        rs = torch.rsqrt(r2)
        if potential:
            phi[s:e] = (-G * ((rs * ml[None, :]).sum(dim=1).to(F64) - ml[s:e].to(F64) / eps2**0.5))
        w = rs * rs * rs * ml[None, :]
        out[s:e] = G * (w[:, :, None] * d).sum(dim=1).to(F64)
    return out, phi


def force_vjp(
    x: torch.Tensor, m: torch.Tensor, fbar: torch.Tensor, G: float, eps2: float, *,
    dtype=F64, block: int | None = None,
) -> torch.Tensor:
    """``xbar_j = sum_i fbar_i . d accel_i / d x_j``, ``(N, 3)`` float64.

    With ``d = x_j - x_i``, ``s = r^2 + eps2`` and ``w = s^(-3/2)``,
    ``d accel_i / d x_j = G m_j K_ij`` for ``i != j`` and ``d accel_i / d
    x_i = -G sum_j m_j K_ij``, where ``K_ij = w I - 3 w d d^T / s`` is
    symmetric in i and j.  So ``xbar_j = G sum_i K_ij (m_j fbar_i - m_i
    fbar_j)``, and the self pair adds zero."""
    n = x.shape[0]
    block = block or default_block(n, 5.0e7)
    xl, ml, fl = x.to(dtype), m.to(dtype), fbar.to(dtype)
    out = torch.empty(n, 3, dtype=F64, device=x.device)
    for s, e in _blocks(n, block):
        # Rows of this block play j; the sum runs over every i.
        d = xl[None, :, :] - xl[s:e, None, :]
        sinv = 1.0 / ((d * d).sum(dim=2) + eps2)
        w = sinv * torch.sqrt(sinv)
        u = ml[s:e, None, None] * fl[None, :, :] - ml[None, :, None] * fl[s:e, None, :]
        du = (d * u).sum(dim=2)
        term = w[:, :, None] * u - (3.0 * w * sinv * du)[:, :, None] * d
        out[s:e] = G * term.sum(dim=1).to(F64)
    return out


def verlet(x, v, a_old, m, G: float, eps2: float, dt: float, *, dtype=F64):
    """One frame-shifted Verlet step in float64 (the force in ``dtype``)."""
    f = accel(x, m, G, eps2, dtype=dtype)
    v_new = v + (a_old + f) * (dt / 2)
    x_new = x + (v_new + f * (dt / 2)) * dt
    return x_new, v_new, f


def follow(x, v, a_old, m, G: float, eps2: float, dt: float, steps: int):
    """``steps`` Verlet steps from ``(x, v, a_old)``, float64."""
    x, v, a = (t.to(F64) for t in (x, v, a_old))
    for _ in range(steps):
        x, v, a = verlet(x, v, a, m, G, eps2, dt)
    return x, v, a


def rollout_grad(x0, v0, m, G: float, eps2: float, dt: float, steps: int, *, dtype=F64) -> torch.Tensor:
    """The gradient by ``v0`` of ``mean_i |x_k,i|^2`` after ``steps``
    Verlet steps from ``(x0, v0)`` with a zero carried acceleration, by the
    adjoint of the step (``(N, 3)`` float64)::

        xbar_n = xbar_{n+1} + VJP_n(fbar_n),  vbar_n = vbar_{n+1} + dt xbar_{n+1},
        fbar_n = dt^2/2 xbar_{n+1} + dt/2 vbar_n + abar_{n+1},  abar_n = dt/2 vbar_n
    """
    n = x0.shape[0]
    x, v, a = x0.to(F64), v0.to(F64), torch.zeros_like(x0, dtype=F64)
    xs = []
    for _ in range(steps):
        xs.append(x)
        x, v, a = verlet(x, v, a, m, G, eps2, dt, dtype=dtype)
    xbar = 2.0 * x / n
    vbar = torch.zeros_like(xbar)
    abar = torch.zeros_like(xbar)
    for xn in reversed(xs):
        vbar = vbar + dt * xbar
        fbar = (dt * dt / 2) * xbar + (dt / 2) * vbar + abar
        abar = (dt / 2) * vbar
        xbar = xbar + force_vjp(xn, m, fbar, G, eps2, dtype=dtype)
    return vbar


def energy(x, v, a_old, m, G: float, eps2: float, dt: float) -> dict:
    """Kinetic and potential energy and the momentum, in float64, of a
    state as frame-shifted Verlet leaves it: ``x`` at t, ``v`` at t - dt and
    ``a_old = f(x(t - dt))``, so that the velocity at t is ``v + (a_old +
    f(x)) dt/2``.  (A first state, with ``a_old = 0``, is read the same way:
    its first step takes ``v + f(x) dt/2`` as the velocity at t.)"""
    xd, md = x.to(F64), m.to(F64)
    a, phi = accel_potential(xd, md, G, eps2)
    vd = v.to(F64) + (a_old.to(F64) + a) * (dt / 2)
    return {
        "ke": 0.5 * float((md * (vd * vd).sum(dim=1)).sum()),
        "pe": 0.5 * float((md * phi).sum()),
        "momentum": (md[:, None] * vd).sum(dim=0),
        "momentum_scale": float((md * vd.norm(dim=1)).sum()),
    }
