"""Host math: perspective / lookAt / projection helpers (numpy).

The port's copy of ``nbody3d_tpu/utils/mathlib.py`` (numpy only, kept
here so that the port imports nothing of the JAX package).

Rebuild of the parts of ``matrix.js`` the render path actually uses (its
``invert``/``rotateX``/``rotateY`` are dead code, SURVEY C17).  Matrices are
``(4, 4)`` float32 numpy arrays in ROW-vector-free, column-vector math
convention; the reference stores them column-major flat — use
:func:`to_column_major` / :func:`from_column_major` at checkpoint / uniform
boundaries.

The vec3 class of the reference (``matrix.js:7-92``) needs no port: numpy
arrays already provide add/sub/scale/dot/cross/norm.
"""

from __future__ import annotations

import math

import numpy as np


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """GL-style perspective matrix (``matrix.js:106-129``):

        f = 1/tan(fovy/2); nf = 1/(near - far)
        [f/aspect 0  0                0
         0        f  0                0
         0        0  (far+near)*nf   2*far*near*nf
         0        0  -1              0]

    Note: this maps view depth to NDC z in [-1, 1] (GL convention) while
    WebGPU clips z/w to [0, 1] — so the reference's *effective* near plane
    sits at ~2*near*far/(near+far) ≈ 2*near.  The rasterizer reproduces
    that quirk for parity (see render.rasterize).
    """
    f = 1.0 / math.tan(fovy / 2.0)
    nf = 1.0 / (near - far)
    out = np.zeros((4, 4), dtype=np.float32)
    out[0, 0] = f / aspect
    out[1, 1] = f
    out[2, 2] = (far + near) * nf
    out[2, 3] = 2.0 * far * near * nf
    out[3, 2] = -1.0
    return out


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """View matrix (``matrix.js:132-163``): z along eye-center, x = up x z,
    y = z x x, translation = -basis . eye."""
    eye = np.asarray(eye, dtype=np.float64)
    z = eye - np.asarray(center, dtype=np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    out = np.zeros((4, 4), dtype=np.float32)
    out[0, :3] = x
    out[1, :3] = y
    out[2, :3] = z
    out[0, 3] = -np.dot(x, eye)
    out[1, 3] = -np.dot(y, eye)
    out[2, 3] = -np.dot(z, eye)
    out[3, 3] = 1.0
    return out


def to_column_major(m: np.ndarray) -> np.ndarray:
    """Flatten a (4,4) matrix to the reference's column-major 16-float layout
    (translation at indices 12..14, ``matrix.js:157-159``)."""
    return np.asarray(m, dtype=np.float32).T.reshape(16)


def from_column_major(flat) -> np.ndarray:
    return np.asarray(flat, dtype=np.float32).reshape(4, 4).T


def mass_to_radius(mass):
    """cbrt(m / (4/3 π)) — unit-density sphere radius (``util.js:123``;
    also inlined in the vertex shader as ``pow(m/4.189, 1/3)``,
    ``nbody3d.js:346``)."""
    return np.cbrt(np.asarray(mass) / (4.0 / 3.0 * math.pi))


def clamp(x, lo, hi):
    """``Number.prototype.clamp`` (``util.js:104``)."""
    return max(lo, min(hi, x))


def to_rad(deg: float) -> float:
    """``Number.prototype.toRad`` (``util.js:110``)."""
    return deg * math.pi / 180.0


def to_deg(rad: float) -> float:
    """``Number.prototype.toDeg`` (``util.js:116``)."""
    return rad / math.pi * 180.0
