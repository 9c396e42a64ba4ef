"""Named presets: ``make_preset(name, seed=, G=, n=)``.

Each preset returns ``(pos_mass (N,4) f32, vel (N,4) f32, camera_target)``
from a numpy generator seeded with ``seed``; the same seed gives the same
arrays, bit for bit, as ``nbody3d_tpu.models.registry.make_preset``.

- ``two-galaxy`` — the reference's default run: 2 random galaxies of
  20,000 disk bodies each (+1 central) => N = 40,002.
- ``reference-random`` — reference-shaped randomized galaxies.
- ``collision`` — deterministic two-galaxy collision.
- ``plummer`` — N=16k Plummer sphere.
- ``uniform-sphere`` — N=1,024 cold uniform ball.
- ``fibonacci-shell`` — the reference's golden-angle shell.
- ``uniform-box`` — cold uniform box.
- ``cosmo`` is not ported: it needs the mesh solvers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from nbody3d_tpu_torch.config import DEFAULT_G, DEFAULT_SIZE_FACTOR, GalaxyConfig
from nbody3d_tpu_torch.models.galaxy import generate_galaxies, random_galaxy_configs
from nbody3d_tpu_torch.models.plummer import plummer_sphere
from nbody3d_tpu_torch.models.sphere import fibonacci_shell, uniform_sphere

MakerResult = tuple[np.ndarray, np.ndarray, np.ndarray]

# Presets of the JAX package that wait for a later part of the port.
NOT_PORTED = {
    "cosmo": "ROADMAP.md queue 1 item 9 (mesh solvers: models/cosmo.py)",
}


def _two_galaxy(seed: int, G: float, n: int | None, size_factor: float) -> MakerResult:
    rng = np.random.default_rng(seed)
    per_galaxy = (n // 2 - 1) if n else 20000
    configs = random_galaxy_configs(2, per_galaxy, per_galaxy, rng)
    return generate_galaxies(configs, G=G, size_factor=size_factor, rng=rng)


def _reference_random(
    seed: int, G: float, n: int | None, size_factor: float, *, num_galaxies=2, min_bodies=20000, max_bodies=20000
) -> MakerResult:
    rng = np.random.default_rng(seed)
    if n is not None:
        per = max(n // num_galaxies - 1, 0)
        min_bodies = max_bodies = per
    configs = random_galaxy_configs(num_galaxies, min_bodies, max_bodies, rng)
    return generate_galaxies(configs, G=G, size_factor=size_factor, rng=rng)


def _collision(seed: int, G: float, n: int | None, size_factor: float) -> MakerResult:
    """Two galaxies on a closing course with skewed disk planes."""
    rng = np.random.default_rng(seed)
    per_galaxy = (n // 2 - 1) if n else 20000
    configs = [
        GalaxyConfig(center=(-4.0, 0.0, 0.0), velocity=(6.0, 1.0, 0.0),
                     normal=(0.2, 1.0, 0.1), radius=3.0, count=per_galaxy),
        GalaxyConfig(center=(4.0, 0.5, 0.0), velocity=(-6.0, -1.0, 0.0),
                     normal=(0.8, 0.5, 0.4), radius=3.0, count=per_galaxy),
    ]
    return generate_galaxies(configs, G=G, size_factor=size_factor, rng=rng)


def _plummer(seed: int, G: float, n: int | None, size_factor: float) -> MakerResult:
    return plummer_sphere(n or 16384, G=G, rng=np.random.default_rng(seed))


def _uniform(seed: int, G: float, n: int | None, size_factor: float) -> MakerResult:
    return uniform_sphere(n or 1024, rng=np.random.default_rng(seed))


def _fib(seed: int, G: float, n: int | None, size_factor: float) -> MakerResult:
    return fibonacci_shell(n or 4096, rng=np.random.default_rng(seed))


def _uniform_box(
    seed: int, G: float, n: int | None, size_factor: float,
    *, box_size: float = 10.0,
) -> MakerResult:
    """Cold uniform box, masses U(10, 50), zero velocities."""
    rng = np.random.default_rng(seed)
    count = n or 16384
    pos = rng.uniform(0.0, box_size, (count, 3))
    pm = np.concatenate(
        [pos, rng.uniform(10.0, 50.0, (count, 1))], axis=1
    ).astype(np.float32)
    vel = np.zeros((count, 4), np.float32)
    return pm, vel, np.full((3,), box_size / 2.0)


PRESETS: dict[str, Callable[..., MakerResult]] = {
    "two-galaxy": _two_galaxy,
    "reference-random": _reference_random,
    "collision": _collision,
    "plummer": _plummer,
    "uniform-sphere": _uniform,
    "fibonacci-shell": _fib,
    "uniform-box": _uniform_box,
}


def make_preset(
    name: str,
    *,
    seed: int = 0,
    G: float = DEFAULT_G,
    n: int | None = None,
    size_factor: float = DEFAULT_SIZE_FACTOR,
    **kw,
) -> MakerResult:
    """Instantiate a named preset. ``n`` overrides the preset's default body
    count where meaningful."""
    if name in NOT_PORTED:
        raise KeyError(f"preset {name!r} is not ported yet: {NOT_PORTED[name]}")
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name](seed, G, n, size_factor, **kw)
