"""Procedural multi-galaxy disk initial conditions.

Vectorized, seeded rebuild of ``generateGalaxy`` (``nbody3d.js:51-133``).
Per galaxy ``[center, centerV, normal, radius, count]``:

- one central body of mass 1e7 at ``center`` with velocity ``centerV``
  (``nbody3d.js:62-68``);
- ``count`` disk bodies with mass ~ U(10, 50) (``nbody3d.js:63-64,88``);
- disk plane from an orthonormal basis {u, v} of the (normalized) normal:
  ``u = normalize(tmp × n)``, ``v = n × u`` with ``tmp = (0,1,0)`` if
  ``|n.x| > 0.9`` else ``(1,0,0)`` (``nbody3d.js:74-84``);
- radial profile ``r(t) = cR + R * (2^(-2(t-1)) - 1) / 3`` with
  ``t = sqrt(U(0,1))`` and core radius
  ``cR = (massToRadius(1e7) + massToRadius(50)) / sizeFactor``
  (``nbody3d.js:65,90-93``);
- vertical thickness ``w ~ U(-0.1, 0.1) / (10 (r/R)^2 + 1)`` along n, with
  in-plane radius shrunk to ``sqrt(r^2 - w^2)`` (``nbody3d.js:95-107``);
- circular-orbit tangential speed ``v = sqrt(G * 1e7 / r)`` using the
  *generation-time* G (``nbody3d.js:114-123``);
- the mass-weighted center of mass of everything generated so far becomes
  the recommended camera target (``nbody3d.js:70-71,110-111,126``).

Unlike the reference's ``Math.random`` (non-reproducible), all draws come
from a caller-supplied ``numpy.random.Generator`` so runs are deterministic
per seed.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from nbody3d_tpu_torch.config import DEFAULT_SIZE_FACTOR, GalaxyConfig

CENTRAL_MASS = 1.0e7  # nbody3d.js:62
MIN_OUTER_MASS = 10.0  # nbody3d.js:64
MAX_OUTER_MASS = 50.0  # nbody3d.js:63
RADIAL_EXP = 2.0  # nbody3d.js:91


def mass_to_radius(mass):
    """Radius of a unit-density sphere: cbrt(m / (4/3 π)) (util.js:123)."""
    return np.cbrt(np.asarray(mass) / (4.0 / 3.0 * math.pi))


def _disk_basis(normal: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Orthonormal {n, u, v} with u, v spanning the disk plane
    (``nbody3d.js:74-84``)."""
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    tmp = np.array([0.0, 1.0, 0.0]) if abs(n[0]) > 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(tmp, n)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    return n, u, v


def generate_galaxies(
    configs: Sequence[GalaxyConfig],
    *,
    G: float,
    size_factor: float = DEFAULT_SIZE_FACTOR,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate the packed body arrays for a list of galaxies.

    Returns ``(pos_mass (N,4) f32, vel (N,4) f32, camera_target (3,) f64)``
    where ``N = sum(count + 1)`` (``nbody3d.js:60``).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    if not configs:
        raise ValueError("need at least one GalaxyConfig (got an empty list)")

    pos_chunks: list[np.ndarray] = []
    vel_chunks: list[np.ndarray] = []
    com = np.zeros(3)
    total_mass = 0.0

    for cfg in configs:
        center = np.asarray(cfg.center, dtype=np.float64)
        center_v = np.asarray(cfg.velocity, dtype=np.float64)
        radius = float(cfg.radius)
        count = int(cfg.count)

        # Central body (nbody3d.js:62-68).
        c_radius = (mass_to_radius(CENTRAL_MASS) + mass_to_radius(MAX_OUTER_MASS)) / size_factor
        pos_chunks.append(np.concatenate([center, [CENTRAL_MASS]])[None, :])
        vel_chunks.append(np.concatenate([center_v, [0.0]])[None, :])
        total_mass += CENTRAL_MASS
        com += center * CENTRAL_MASS

        n, u, v = _disk_basis(np.asarray(cfg.normal, dtype=np.float64))

        # Disk bodies, vectorized (nbody3d.js:87-125).
        mass = rng.uniform(MIN_OUTER_MASS, MAX_OUTER_MASS, size=count)
        t = np.sqrt(rng.uniform(0.0, 1.0, size=count))
        r = c_radius + radius * (2.0 ** (-RADIAL_EXP * (t - 1.0)) - 1.0) / (
            2.0**RADIAL_EXP - 1.0
        )
        theta = rng.uniform(0.0, 2.0 * math.pi, size=count)
        w_scale = rng.uniform(-0.1, 0.1, size=count) / (10.0 * (r / radius) ** 2 + 1.0)
        w_pos = w_scale[:, None] * n[None, :]
        planar = np.sqrt(np.maximum(r * r - np.abs(w_scale) ** 2, 0.0))
        offset = (
            planar[:, None] * np.cos(theta)[:, None] * u[None, :]
            + planar[:, None] * np.sin(theta)[:, None] * v[None, :]
        )
        xyz = center[None, :] + w_pos + offset

        com += np.sum(xyz * mass[:, None], axis=0)
        total_mass += np.sum(mass)

        tangent = theta + math.pi / 2.0
        speed = np.sqrt(G * CENTRAL_MASS / r)  # generation-time G (nbody3d.js:115)
        vel_xyz = (
            center_v[None, :]
            + (speed * np.cos(tangent))[:, None] * u[None, :]
            + (speed * np.sin(tangent))[:, None] * v[None, :]
        )

        pos_chunks.append(np.concatenate([xyz, mass[:, None]], axis=1))
        vel_chunks.append(
            np.concatenate([vel_xyz, np.zeros((count, 1))], axis=1)
        )

    pos_mass = np.concatenate(pos_chunks, axis=0).astype(np.float32)
    vel = np.concatenate(vel_chunks, axis=0).astype(np.float32)
    camera_target = com / max(total_mass, 1e-30)
    return pos_mass, vel, camera_target


def random_galaxy_configs(
    num_galaxies: int,
    min_bodies: int,
    max_bodies: int,
    rng: np.random.Generator,
) -> list[GalaxyConfig]:
    """The reference's per-run randomized galaxy settings
    (``nbody3d.js:163-177``): center ~ U(-5,5)^3, bulk velocity ~ U(-10,10)^3,
    normal ~ U(0,1)^3, radius ~ U(2,5), count = round(U(min, max))."""
    configs = []
    for _ in range(num_galaxies):
        configs.append(
            GalaxyConfig(
                center=tuple(rng.uniform(-5.0, 5.0, size=3)),
                velocity=tuple(rng.uniform(-10.0, 10.0, size=3)),
                normal=tuple(rng.uniform(0.0, 1.0, size=3)),
                radius=float(rng.uniform(2.0, 5.0)),
                count=int(round(rng.uniform(min_bodies, max_bodies))),
            )
        )
    return configs
