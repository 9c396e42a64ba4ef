"""Uniform-ball cloud (BASELINE config #1) and the Fibonacci shell.

The Fibonacci shell reproduces the reference's dead-code ``createPoints``
generator (``util.js:135-152``): points on a sphere surface via the golden
angle increment, with masses ~ U(0, 2000) and zero velocities.
"""

from __future__ import annotations

import math

import numpy as np


def uniform_sphere(
    count: int,
    *,
    radius: float = 3.0,
    mass_range: tuple[float, float] = (10.0, 50.0),
    center: tuple[float, float, float] = (0.0, 0.0, 0.0),
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cold uniform-density ball: r ~ radius * U^{1/3}, isotropic, v = 0."""
    if rng is None:
        rng = np.random.default_rng(0)
    r = radius * rng.uniform(0.0, 1.0, size=count) ** (1.0 / 3.0)
    z = rng.uniform(-1.0, 1.0, size=count)
    phi = rng.uniform(0.0, 2.0 * math.pi, size=count)
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    xyz = np.asarray(center, dtype=np.float64)[None, :] + r[:, None] * np.stack(
        [s * np.cos(phi), s * np.sin(phi), z], axis=1
    )
    mass = rng.uniform(mass_range[0], mass_range[1], size=count)
    pos_mass = np.concatenate([xyz, mass[:, None]], axis=1).astype(np.float32)
    vel = np.zeros((count, 4), dtype=np.float32)
    return pos_mass, vel, np.asarray(center, dtype=np.float64)


def fibonacci_shell(
    count: int,
    *,
    radius: float = 3.0,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Golden-angle spherical shell (``util.js:135-152``):

        increment = π (3 - √5)
        y_i = (i * 2/N - 1) + 1/N;  r_i = sqrt(1 - y_i²);  φ_i = i * increment
        mass ~ U(0, 2000), velocities zero.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    i = np.arange(count, dtype=np.float64)
    increment = math.pi * (3.0 - math.sqrt(5.0))
    offset = 2.0 / count
    y = (i * offset - 1.0) + offset / 2.0
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    phi = i * increment
    xyz = radius * np.stack([np.cos(phi) * r, y, np.sin(phi) * r], axis=1)
    mass = rng.uniform(0.0, 2000.0, size=count)
    pos_mass = np.concatenate([xyz, mass[:, None]], axis=1).astype(np.float32)
    vel = np.zeros((count, 4), dtype=np.float32)
    return pos_mass, vel, np.zeros(3)
