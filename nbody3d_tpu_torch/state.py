"""Simulation state: three ``(N_pad, 4)`` float32 tensors and a step count.

``pos_mass`` holds ``(x, y, z, mass)``, ``vel`` ``(vx, vy, vz, 0)`` and
``accel`` ``(ax, ay, az, 0)``.  Because the integrator is frame-shifted
velocity Verlet, the lagged acceleration is part of the state.  ``N_pad``
is the body count rounded up to the kernels' padding granule; padding
bodies have mass 0, so they exert no force, and the step keeps them
frozen with zero stored acceleration.

The JAX package donates an immutable state to ``lax.scan``; here the
tensors live on one device for the whole run and the fused sym step
updates them in place (``ops/cuda_force.py::sym_epilogue_``), so a step
allocates no new state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SimState:
    pos_mass: torch.Tensor  # (N_pad, 4) f32: x, y, z, mass
    vel: torch.Tensor  # (N_pad, 4) f32: vx, vy, vz, 0
    accel: torch.Tensor  # (N_pad, 4) f32: ax, ay, az, 0
    step: int = 0

    @property
    def n_pad(self) -> int:
        return self.pos_mass.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos_mass.device


def pad_count(n: int, multiple: int) -> int:
    """Round ``n`` up to a multiple of ``multiple``."""
    if multiple <= 0:
        raise ValueError(f"pad multiple must be positive, got {multiple}")
    return -(-n // multiple) * multiple


def _as_f32_rows(a, name: str) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"{name} must be (N, 4), got {a.shape}")
    return a


def init_state(
    pos_mass: np.ndarray,
    vel: np.ndarray,
    accel: np.ndarray | None = None,
    *,
    device: torch.device | str,
    n_pad: int | None = None,
    step: int = 0,
) -> SimState:
    """Build a :class:`SimState` on ``device`` from (possibly unpadded)
    host arrays.  ``accel=None`` starts from a zero acceleration, as the
    reference's first Verlet kick does."""
    pos_mass = _as_f32_rows(pos_mass, "pos_mass")
    vel = _as_f32_rows(vel, "vel")
    if vel.shape != pos_mass.shape:
        raise ValueError(f"vel shape {vel.shape} != pos_mass shape {pos_mass.shape}")
    n = pos_mass.shape[0]
    n_pad = n if n_pad is None else n_pad
    if n_pad < n:
        raise ValueError(f"n_pad={n_pad} smaller than body count {n}")
    if accel is None:
        accel = np.zeros_like(pos_mass)
    else:
        accel = _as_f32_rows(accel, "accel")
        if accel.shape != pos_mass.shape:
            raise ValueError(f"accel shape {accel.shape} != {pos_mass.shape}")

    def pad(a: np.ndarray) -> torch.Tensor:
        out = np.zeros((n_pad, 4), dtype=np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    return SimState(pad(pos_mass), pad(vel), pad(accel), int(step))


def state_from_numpy(
    pos_mass: np.ndarray,
    vel: np.ndarray,
    accel: np.ndarray,
    *,
    device: torch.device | str,
    step: int = 0,
    n_pad: int | None = None,
) -> SimState:
    """Carry a state over from the JAX package: the real rows of its
    ``pos_mass``/``vel``/``accel`` (e.g. ``nbody3d_tpu.state.unpad``)
    become the port's state, lagged acceleration included, bit for bit."""
    return init_state(pos_mass, vel, accel, n_pad=n_pad, step=step, device=device)


def unpad(state: SimState, n_real: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host copies of the real (unpadded) rows."""
    return tuple(
        t[:n_real].detach().cpu().numpy().copy()
        for t in (state.pos_mass, state.vel, state.accel)
    )
