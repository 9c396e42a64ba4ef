"""The ``two-galaxy`` preset, frozen: a copy of
``nbody3d_tpu_torch/models/registry.py::_two_galaxy`` and of
``nbody3d_tpu_torch/models/galaxy.py``'s ``generate_galaxies`` and
``random_galaxy_configs`` (themselves the reference app's ``generateGalaxy``,
``nbody3d.js:51-133``, and its randomized settings, ``nbody3d.js:163-177``).

Per galaxy: a centre of mass 1e7, then ``count`` disk bodies of mass
U(10, 50) on circular orbits about it; the draws come from
``numpy.random.default_rng(seed)`` in the copied order, so a seed gives the
arrays the program's preset gives, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

CENTRAL_MASS = 1.0e7
MIN_OUTER_MASS = 10.0
MAX_OUTER_MASS = 50.0
RADIAL_EXP = 2.0


def _mass_to_radius(mass):
    return np.cbrt(np.asarray(mass) / (4.0 / 3.0 * math.pi))


def _disk_basis(normal):
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    tmp = np.array([0.0, 1.0, 0.0]) if abs(n[0]) > 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(tmp, n)
    u = u / np.linalg.norm(u)
    return n, u, np.cross(n, u)


def _galaxy_settings(num: int, min_bodies: int, max_bodies: int, rng) -> list[dict]:
    out = []
    for _ in range(num):
        out.append({
            "center": tuple(rng.uniform(-5.0, 5.0, size=3)),
            "velocity": tuple(rng.uniform(-10.0, 10.0, size=3)),
            "normal": tuple(rng.uniform(0.0, 1.0, size=3)),
            "radius": float(rng.uniform(2.0, 5.0)),
            "count": int(round(rng.uniform(min_bodies, max_bodies))),
        })
    return out


def _generate(settings: list[dict], G: float, size_factor: float, rng) -> tuple[np.ndarray, np.ndarray]:
    pos_chunks, vel_chunks = [], []
    for cfg in settings:
        center = np.asarray(cfg["center"], dtype=np.float64)
        center_v = np.asarray(cfg["velocity"], dtype=np.float64)
        radius, count = float(cfg["radius"]), int(cfg["count"])
        c_radius = (_mass_to_radius(CENTRAL_MASS) + _mass_to_radius(MAX_OUTER_MASS)) / size_factor
        pos_chunks.append(np.concatenate([center, [CENTRAL_MASS]])[None, :])
        vel_chunks.append(np.concatenate([center_v, [0.0]])[None, :])
        n, u, v = _disk_basis(cfg["normal"])
        mass = rng.uniform(MIN_OUTER_MASS, MAX_OUTER_MASS, size=count)
        t = np.sqrt(rng.uniform(0.0, 1.0, size=count))
        r = c_radius + radius * (2.0 ** (-RADIAL_EXP * (t - 1.0)) - 1.0) / (2.0**RADIAL_EXP - 1.0)
        theta = rng.uniform(0.0, 2.0 * math.pi, size=count)
        w_scale = rng.uniform(-0.1, 0.1, size=count) / (10.0 * (r / radius) ** 2 + 1.0)
        planar = np.sqrt(np.maximum(r * r - np.abs(w_scale) ** 2, 0.0))
        offset = (planar * np.cos(theta))[:, None] * u[None, :] + (planar * np.sin(theta))[:, None] * v[None, :]
        xyz = center[None, :] + w_scale[:, None] * n[None, :] + offset
        tangent = theta + math.pi / 2.0
        speed = np.sqrt(G * CENTRAL_MASS / r)
        vel_xyz = (
            center_v[None, :]
            + (speed * np.cos(tangent))[:, None] * u[None, :]
            + (speed * np.sin(tangent))[:, None] * v[None, :]
        )
        pos_chunks.append(np.concatenate([xyz, mass[:, None]], axis=1))
        vel_chunks.append(np.concatenate([vel_xyz, np.zeros((count, 1))], axis=1))
    return (np.concatenate(pos_chunks).astype(np.float32), np.concatenate(vel_chunks).astype(np.float32))


def make(config: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``config``: ``n`` (2 x (per galaxy + 1)), ``G``, ``size_factor``."""
    rng = np.random.default_rng(seed)
    per_galaxy = config["n"] // 2 - 1
    settings = _galaxy_settings(2, per_galaxy, per_galaxy, rng)
    return _generate(settings, float(config["G"]), float(config["size_factor"]), rng)
