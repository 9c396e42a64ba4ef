"""The ``uniform-sphere`` preset, frozen: a copy of
``nbody3d_tpu_torch/models/sphere.py::uniform_sphere`` as
``nbody3d_tpu_torch/models/registry.py::_uniform`` calls it (radius 3,
masses U(10, 50), centred at the origin, at rest): r = 3 U^(1/3),
isotropic directions, drawn from ``numpy.random.default_rng(seed)`` in the
copied order.
"""

from __future__ import annotations

import math

import numpy as np


def make(config: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``config``: ``n``; the radius and mass range are the preset's."""
    count = int(config["n"])
    rng = np.random.default_rng(seed)
    r = 3.0 * rng.uniform(0.0, 1.0, size=count) ** (1.0 / 3.0)
    z = rng.uniform(-1.0, 1.0, size=count)
    phi = rng.uniform(0.0, 2.0 * math.pi, size=count)
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    xyz = r[:, None] * np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)
    mass = rng.uniform(10.0, 50.0, size=count)
    pos_mass = np.concatenate([xyz, mass[:, None]], axis=1).astype(np.float32)
    return pos_mass, np.zeros((count, 4), dtype=np.float32)
