"""Velocity colormap — the fragment shader's ``colorMap``.

The port's copy of ``nbody3d_tpu/render/colormap.py`` (numpy, for the host
prep; the device prep in ``rasterize.py`` repeats it in torch).

``nbody3d.js:371-372,380``: value = |vel| / 40, then
``rgb = (v, 1 - |v - 0.5|, 1 - v)``, implicitly clamped to [0, 1] by the
render target.  The color-by-direction variant (dead code in the
reference at ``nbody3d.js:381``) is implemented here as
:func:`direction_colormap` and exposed via the CLI ``--color-mode``
flag.
"""

from __future__ import annotations

import numpy as np

VELOCITY_SCALE = 40.0  # nbody3d.js:380


def velocity_colormap(speed: np.ndarray) -> np.ndarray:
    """Map speeds (any shape) to float RGB in [0, 1], shape (..., 3)."""
    v = np.asarray(speed, dtype=np.float32) / VELOCITY_SCALE
    r = v
    g = 1.0 - np.abs(v - 0.5)
    b = 1.0 - v
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def direction_colormap(vel3: np.ndarray) -> np.ndarray:
    """Color by velocity direction: ``normalize(vel) * 0.5 + 0.5`` — the
    reference's alternate visualization (``nbody3d.js:381``).  (N, 3) in,
    RGB in [0, 1] out; zero velocities map to mid-gray."""
    v = np.asarray(vel3, dtype=np.float32)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    unit = np.divide(v, norm, out=np.zeros_like(v), where=norm > 0)
    return np.clip(unit * 0.5 + 0.5, 0.0, 1.0)
