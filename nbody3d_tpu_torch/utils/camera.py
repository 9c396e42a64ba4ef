"""Orbital camera: full rebuild of ``camera.js`` minus the DOM.

The port's copy of ``nbody3d_tpu/utils/camera.py`` (numpy only), with the
reference's 8-field checkpoint schema (``to_dict``/``from_dict``).

State and operations mirror ``class Camera`` (``camera.js:25-129``):
spherical (azimuth, elevation, radius) orbit around ``target``; eye
position ``target + radius * (cos e sin a, sin e, cos e cos a)``
(``camera.js:65-69``); view-projection = ``perspective @ look_at``
(``camera.js:54-58``).  Interaction handlers (mouse/key event plumbing,
``camera.js:132-251``) have no headless counterpart — the *operations* they
drive (orbit/pan/zoom/FOV/dolly/reset) are all here, with the same speed
constants, so scripted camera paths can reproduce any interactive motion.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from nbody3d_tpu_torch.utils import mathlib

# Interaction speed constants (camera.js:1-9).
ROT_SPEED = 0.005
PAN_SPEED = 0.001
ZOOM_SPEED = 0.0005
FOV_SPEED = 0.0002
KEY_ROT_SPEED = 3
KEY_PAN_SPEED = 5
KEY_ZOOM_SPEED = 0.01
KEY_FOV_SPEED = 0.005

MIN_FOV = mathlib.to_rad(10.0)  # camera.js:11
MAX_FOV = mathlib.to_rad(120.0)

# Defaults (camera.js:13-22).
DEFAULT_RADIUS = 5.0
DEFAULT_FOV = mathlib.to_rad(60.0)
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 1e5


@dataclasses.dataclass
class Camera:
    target: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    radius: float = DEFAULT_RADIUS
    azimuth: float = 0.0
    elevation: float = 0.0
    fov: float = DEFAULT_FOV
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR

    def __post_init__(self):
        self.target = np.asarray(self.target, dtype=np.float64)
        self.world_up = np.array([0.0, 1.0, 0.0])
        self._defaults = (
            self.target.copy(),
            self.radius,
            self.azimuth,
            self.elevation,
            self.fov,
        )

    # ------------------------------------------------------------ geometry
    @property
    def position(self) -> np.ndarray:
        """Eye position (``camera.js:65-69``)."""
        x = math.cos(self.elevation) * math.sin(self.azimuth)
        y = math.sin(self.elevation)
        z = math.cos(self.elevation) * math.cos(self.azimuth)
        return self.target + self.radius * np.array([x, y, z])

    @property
    def view_dir(self) -> np.ndarray:
        d = self.target - self.position
        return d / np.linalg.norm(d)

    @property
    def view_right(self) -> np.ndarray:
        r = np.cross(self.view_dir, self.world_up)
        return r / np.linalg.norm(r)

    @property
    def view_up(self) -> np.ndarray:
        u = np.cross(self.view_right, self.view_dir)
        return u / np.linalg.norm(u)

    def view_proj(self, aspect: float) -> tuple[np.ndarray, float]:
        """(view-projection matrix, f = proj[5]) — what ``updateMatrix``
        writes into the uniform block (``camera.js:54-63``)."""
        proj = mathlib.perspective(self.fov, aspect, self.near, self.far)
        view = mathlib.look_at(self.position, self.target, self.world_up)
        return (proj @ view).astype(np.float32), float(proj[1, 1])

    # ---------------------------------------------------------- operations
    def orbit(self, dx: float, dy: float) -> None:
        """``camera.js:81-88``: azimuth -= dx*ROT_SPEED, elevation += dy*...,
        elevation clamped to ±(π/2 - 0.01)."""
        self.azimuth -= dx * ROT_SPEED
        self.elevation += dy * ROT_SPEED
        limit = math.pi / 2 - 0.01
        self.elevation = mathlib.clamp(self.elevation, -limit, limit)

    def pan(self, dx: float, dy: float) -> None:
        """``camera.js:90-100``: view-plane translation of target+eye, speed
        ∝ radius * fov."""
        speed = PAN_SPEED * self.radius * self.fov
        pan = self.view_right * (-dx * speed) + self.view_up * (dy * speed)
        self.target = self.target + pan

    def zoom(self, delta: float) -> None:
        """``camera.js:102-105``: multiplicative radius, clamped [near, far]."""
        self.radius = mathlib.clamp((delta + 1.0) * self.radius, self.near, self.far)

    def adj_fov(self, delta: float) -> None:
        """``camera.js:107-110``."""
        self.fov = mathlib.clamp(self.fov + delta, MIN_FOV, MAX_FOV)

    def adj_fov_without_zoom(self, delta: float) -> None:
        """Dolly zoom keeping subject size (``camera.js:112-117``):
        radius' = tan(fov/2)*radius / tan(fov'/2)."""
        initial = math.tan(self.fov / 2.0) * self.radius
        self.fov = mathlib.clamp(self.fov + delta, MIN_FOV, MAX_FOV)
        self.radius = initial / math.tan(self.fov / 2.0)

    def reset(self, *, ctrl: bool = False, alt: bool = False) -> None:
        """``camera.js:119-128``: fov always; radius unless ctrl; pose/target
        unless ctrl or alt."""
        target0, radius0, az0, el0, fov0 = self._defaults
        self.fov = fov0
        if not ctrl:
            self.radius = radius0
        if not alt and not ctrl:
            self.azimuth = az0
            self.elevation = el0
            self.target = target0.copy()

    def describe(self) -> str:
        """One-line pose summary — the HUD's live camera block
        (``camera.js:73-78``, ``index.html:36-48``) as a log field."""
        t, p = self.target, self.position
        return (
            f"cam target=({t[0]:.3g},{t[1]:.3g},{t[2]:.3g}) "
            f"pos=({p[0]:.3g},{p[1]:.3g},{p[2]:.3g}) r={self.radius:.4g} "
            f"az={math.degrees(self.azimuth):.1f}° "
            f"el={math.degrees(self.elevation):.1f}° "
            f"fov={math.degrees(self.fov):.1f}°"
        )

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """Reference checkpoint camera schema (``util.js:191-199``)."""
        return {
            "target": [float(v) for v in self.target],
            "position": [float(v) for v in self.position],
            "radius": float(self.radius),
            "azimuth": float(self.azimuth),
            "elevation": float(self.elevation),
            "fov": float(self.fov),
            "near": float(self.near),
            "far": float(self.far),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Camera":
        """Restore from the reference schema (``util.js:247-258``; the stored
        ``position`` is derived state and is recomputed, matching the
        reference's ``updatePosition`` call at ``util.js:257``)."""
        return cls(
            target=np.asarray(d["target"], dtype=np.float64),
            radius=float(d["radius"]),
            azimuth=float(d["azimuth"]),
            elevation=float(d["elevation"]),
            fov=float(d["fov"]),
            near=float(d["near"]),
            far=float(d["far"]),
        )
