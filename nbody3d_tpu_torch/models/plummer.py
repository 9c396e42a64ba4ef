"""Plummer-sphere initial conditions (BASELINE config #2).

No reference counterpart — the reference only ships the disk-galaxy
generator (``nbody3d.js:51-133``) — but the Plummer model is the canonical
validation workload for softened N-body codes and BASELINE.json pins it as
the N=16k energy/momentum-drift config.

Standard Aarseth/Hut sampling of the Plummer (1911) profile with scale
radius ``a`` and total mass ``M``:

- radius:  ``r = a * (U^{-2/3} - 1)^{-1/2}`` for U ~ U(0,1);
- isotropic direction on the sphere;
- speed:  ``v = q * v_esc(r)`` with ``v_esc = sqrt(2 G M) * (r^2+a^2)^{-1/4}``
  and q drawn by rejection from ``g(q) = q^2 (1 - q^2)^{7/2}``.
"""

from __future__ import annotations

import numpy as np


def _sample_unit_sphere(rng: np.random.Generator, n: int) -> np.ndarray:
    z = rng.uniform(-1.0, 1.0, size=n)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n)
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)


def _sample_q(rng: np.random.Generator, n: int) -> np.ndarray:
    """Rejection-sample q in [0,1] from g(q) = q^2 (1-q^2)^{7/2}.

    g has max ~0.0922 at q = sqrt(2/9); use envelope 0.1.
    """
    out = np.empty(n)
    filled = 0
    while filled < n:
        m = max((n - filled) * 2, 1024)
        q = rng.uniform(0.0, 1.0, size=m)
        y = rng.uniform(0.0, 0.1, size=m)
        ok = q[y < q * q * (1.0 - q * q) ** 3.5]
        take = min(len(ok), n - filled)
        out[filled : filled + take] = ok[:take]
        filled += take
    return out


def plummer_sphere(
    count: int,
    *,
    G: float,
    total_mass: float = 1.0e6,
    scale_radius: float = 1.0,
    center: tuple[float, float, float] = (0.0, 0.0, 0.0),
    velocity: tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_radius_factor: float = 10.0,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Equal-mass Plummer sphere in approximate virial equilibrium.

    Returns ``(pos_mass (N,4) f32, vel (N,4) f32, camera_target (3,))``.
    ``max_radius_factor`` truncates the (formally infinite) profile.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    a = float(scale_radius)
    m_each = float(total_mass) / count

    # Radii (resample the truncated tail so the draw count stays exact).
    r = np.empty(count)
    filled = 0
    while filled < count:
        m = max((count - filled) * 2, 1024)
        u = rng.uniform(1e-12, 1.0, size=m)
        cand = a / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
        ok = cand[cand < max_radius_factor * a]
        take = min(len(ok), count - filled)
        r[filled : filled + take] = ok[:take]
        filled += take

    xyz = np.asarray(center, dtype=np.float64)[None, :] + r[:, None] * _sample_unit_sphere(
        rng, count
    )

    v_esc = np.sqrt(2.0 * G * total_mass) * (r * r + a * a) ** (-0.25)
    speed = _sample_q(rng, count) * v_esc
    vel_xyz = np.asarray(velocity, dtype=np.float64)[None, :] + speed[:, None] * _sample_unit_sphere(rng, count)

    pos_mass = np.concatenate(
        [xyz, np.full((count, 1), m_each)], axis=1
    ).astype(np.float32)
    vel = np.concatenate([vel_xyz, np.zeros((count, 1))], axis=1).astype(np.float32)
    return pos_mass, vel, np.asarray(center, dtype=np.float64)
