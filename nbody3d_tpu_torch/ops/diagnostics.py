"""Conservation diagnostics: energy, momentum, angular momentum.

Potential energy uses the force's Plummer softening::

    U = -G/2 * sum_{i != j} m_i m_j / sqrt(|r_ij|^2 + eps2)

so that E = T + U is the conserved quantity of the softened Hamiltonian
the integrator follows.  All sums are float32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Diagnostics(NamedTuple):
    kinetic: torch.Tensor  # () f32
    potential: torch.Tensor  # () f32
    total_energy: torch.Tensor  # () f32
    momentum: torch.Tensor  # (3,) f32  sum m v
    angular_momentum: torch.Tensor  # (3,) f32  sum m (x × v)
    total_mass: torch.Tensor  # () f32


def kinetic_energy(pos_mass: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    m = pos_mass[:, 3]
    v2 = torch.sum(vel[:, :3] * vel[:, :3], dim=1)
    return 0.5 * torch.sum(m * v2)


def potential_energy(
    pos_mass: torch.Tensor, G: float, *, eps2: float = 1e-4, chunk: int | None = None
) -> torch.Tensor:
    """Softened pairwise potential.  O(N^2); ``chunk`` bounds memory."""
    n = pos_mass.shape[0]
    pos = pos_mass[:, :3]
    m = pos_mass[:, 3]
    if chunk is None or chunk >= n:
        chunk = n
    if n % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide N {n}")
    src_idx = torch.arange(n, device=pos_mass.device)
    parts = []
    for s in range(0, n, chunk):
        tpos = pos[s : s + chunk]
        diff = pos[None, :, :] - tpos[:, None, :]
        d2 = torch.sum(diff * diff, dim=-1) + eps2
        pair = m[s : s + chunk, None] * m[None, :] * torch.rsqrt(d2)
        pair = torch.where(src_idx[None, :] == src_idx[s : s + chunk, None], 0.0, pair)
        parts.append(torch.sum(pair))
    return -0.5 * float(G) * torch.sum(torch.stack(parts))


def momentum(pos_mass: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    return torch.sum(pos_mass[:, 3:4] * vel[:, :3], dim=0)


def angular_momentum(pos_mass: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    return torch.sum(
        pos_mass[:, 3:4] * torch.linalg.cross(pos_mass[:, :3], vel[:, :3]), dim=0
    )


def center_of_mass(pos_mass: torch.Tensor) -> torch.Tensor:
    m = pos_mass[:, 3:4]
    return torch.sum(m * pos_mass[:, :3], dim=0) / torch.clamp(torch.sum(m), min=1e-30)


def compute(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    G: float,
    *,
    eps2: float = 1e-4,
    chunk: int | None = None,
) -> Diagnostics:
    ke = kinetic_energy(pos_mass, vel)
    pe = potential_energy(pos_mass, G, eps2=eps2, chunk=chunk)
    return Diagnostics(
        kinetic=ke,
        potential=pe,
        total_energy=ke + pe,
        momentum=momentum(pos_mass, vel),
        angular_momentum=angular_momentum(pos_mass, vel),
        total_mass=torch.sum(pos_mass[:, 3]),
    )
