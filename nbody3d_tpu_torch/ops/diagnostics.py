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
    pos_mass: torch.Tensor,
    G: float,
    *,
    eps2: float = 1e-4,
    chunk: int | None = None,
    sources: torch.Tensor | None = None,
    row0: int = 0,
) -> torch.Tensor:
    """Softened pairwise potential.  O(N^2); ``chunk`` bounds memory.
    With ``sources`` (a sharded state's gathered rows, of which
    ``pos_mass`` are rows ``row0 ..``), the part of it that these rows
    carry: half of each of their pairs, the self pair left out by index."""
    n = pos_mass.shape[0]
    src = pos_mass if sources is None else sources
    m = pos_mass[:, 3]
    if chunk is None or chunk >= n:
        chunk = n
    if n % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide N {n}")
    src_idx = torch.arange(src.shape[0], device=pos_mass.device)
    parts = []
    for s in range(0, n, chunk):
        tpos = pos_mass[s : s + chunk, :3]
        diff = src[None, :, :3] - tpos[:, None, :]
        d2 = torch.sum(diff * diff, dim=-1) + eps2
        pair = m[s : s + chunk, None] * src[None, :, 3] * torch.rsqrt(d2)
        pair = torch.where(src_idx[None, :] == src_idx[row0 + s : row0 + s + chunk, None], 0.0, pair)
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
