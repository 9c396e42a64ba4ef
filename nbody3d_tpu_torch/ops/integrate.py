"""Integrators: frame-shifted velocity Verlet (the reference's), Euler, and
the 4th-order symplectic Yoshida composition.

Verlet with one-frame acceleration lag::

    v' = v + (a_old + a_new) * dt/2
    x' = x + (v' + a_new * dt/2) * dt
    a_old <- a_new

The operations run in this order in float32, as in
``nbody3d_tpu/ops/integrate.py``, so the two packages agree bit for bit on
the same inputs.  All four lanes update; the w lanes stay put because
``vel.w == accel.w == 0``.  ``valid`` (an ``(N, 1)`` bool mask) freezes
padded rows and zeroes their stored acceleration.  ``dt`` is a float or a
0-d float32 tensor; a tensor stays in the graph, so autograd gives ``dt``
its gradient.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nbody3d_tpu_torch.state import SimState

Tensors3 = tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Accum = Callable[[torch.Tensor], torch.Tensor]


def _f32(x: float | torch.Tensor) -> float | torch.Tensor:
    """``x`` rounded to float32, as a Python float (torch then applies it
    to float32 tensors without further rounding).  A 0-d float32 tensor
    passes through, so that autograd reaches it."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


def apply_integrator(
    kind: str,
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel_old: torch.Tensor,
    accel_new: torch.Tensor,
    dt: float | torch.Tensor,
    valid: torch.Tensor | None = None,
) -> Tensors3:
    """One update from a precomputed acceleration.  Returns
    ``(new_pos_mass, new_vel, new_accel)``."""
    dt = _f32(dt)
    if kind == "verlet":
        half_dt = dt * 0.5
        new_vel = vel + (accel_old + accel_new) * half_dt
        new_pos = pos_mass + (new_vel + accel_new * half_dt) * dt
    elif kind == "euler":
        new_vel = vel + accel_new * dt
        new_pos = pos_mass + new_vel * dt
    else:
        raise ValueError(f"unknown integrator {kind!r}")
    if valid is not None:
        new_pos = torch.where(valid, new_pos, pos_mass)
        new_vel = torch.where(valid, new_vel, vel)
        accel_new = torch.where(valid, accel_new, 0.0)
    return new_pos, new_vel, accel_new


def valid_mask(n_pad: int, n_real: int | None, device) -> torch.Tensor | None:
    """``(n_pad, 1)`` mask of real rows, or None when nothing is padded."""
    if n_real is None or n_real >= n_pad:
        return None
    return torch.arange(n_pad, device=device)[:, None] < n_real


# Yoshida (1990) 4th-order triple-jump coefficients.
_CBRT2 = 2.0 ** (1.0 / 3.0)
_Y4_W1 = 1.0 / (2.0 - _CBRT2)
_Y4_W0 = 1.0 - 2.0 * _Y4_W1
Y4_DRIFT = (
    _Y4_W1 / 2.0,
    (_Y4_W0 + _Y4_W1) / 2.0,
    (_Y4_W0 + _Y4_W1) / 2.0,
    _Y4_W1 / 2.0,
)
Y4_KICK = (_Y4_W1, _Y4_W0, _Y4_W1)

#: force evaluations per step, per integrator.
FORCE_EVALS = {"verlet": 1, "euler": 1, "yoshida4": 3}


def integrate_from_accum(
    kind: str,
    accum: Accum,
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel_old: torch.Tensor,
    dt: float | torch.Tensor,
    valid: torch.Tensor | None = None,
) -> Tensors3:
    """One step given the force closure ``accum(pos_mass) -> (N, 4)``.
    ``yoshida4`` evaluates it three times and stores the last."""
    if kind in ("verlet", "euler"):
        return apply_integrator(
            kind, pos_mass, vel, accel_old, accum(pos_mass), dt, valid
        )
    if kind != "yoshida4":
        raise ValueError(f"unknown integrator {kind!r}")
    dt32 = _f32(dt)

    def coef(c: float) -> float | torch.Tensor:  # c * dt, one f32 product
        return _f32(float(np.float32(c)) * dt32)

    p = pos_mass + coef(Y4_DRIFT[0]) * vel
    v = vel
    a = accel_old
    for ci, di in zip(Y4_DRIFT[1:], Y4_KICK):
        a = accum(p)
        v = v + coef(di) * a
        p = p + coef(ci) * v
    if valid is not None:
        p = torch.where(valid, p, pos_mass)
        v = torch.where(valid, v, vel)
        a = torch.where(valid, a, 0.0)
    return p, v, a


def integrate_state(
    kind: str,
    accum: Accum,
    state: SimState,
    dt: float | torch.Tensor,
    *,
    n_real: int | None = None,
) -> SimState:
    """:func:`integrate_from_accum` over a :class:`SimState`."""
    p, v, a = integrate_from_accum(
        kind, accum, state.pos_mass, state.vel, state.accel, dt,
        valid_mask(state.n_pad, n_real, state.device),
    )
    return SimState(p, v, a, state.step + 1)
