"""Simulation configuration, shared field for field with ``nbody3d_tpu``.

``SimConfig`` keeps the JAX package's field names, defaults and JSON
(``to_json``/``from_json``), so a config written by either package loads
in the other.  Fields that select paths the port does not have yet (mesh
solvers, periodic boundary, cosmology, multi-device strategies, the
``fast`` mode) are kept for that interchange; choosing them raises
``NotImplementedError`` in :mod:`nbody3d_tpu_torch.ops.step`.

``dt`` and ``G`` stored here are defaults: the engine passes them to every
step as runtime scalars (the live sliders), and no kernel is rebuilt when
they change.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

DEFAULT_G = 1e-4
DEFAULT_DT = 1e-4
DEFAULT_EPS2 = 1e-4
DEFAULT_SIZE_FACTOR = 1000.0


@dataclasses.dataclass(frozen=True)
class GalaxyConfig:
    """One disk galaxy: ``[center, centerV, normal, radius, count]``."""

    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    normal: tuple[float, float, float] = (0.0, 1.0, 0.0)
    radius: float = 3.0
    count: int = 20000


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration.

    The port reads: ``dt``, ``G``, ``eps2``, ``integrator``, ``method``
    (``"direct"`` only), ``boundary`` (``"isolated"`` only), ``cosmology``
    (``"none"`` only), ``backend``, ``block_target`` (capped at the GPU
    tile), ``force_mode`` (``"exact"`` or ``"sym"``), ``morton_every``,
    ``fuse_integrate`` (``False`` only), ``fuse_epilogue``,
    ``grad_precision``, ``seed`` and ``size_factor``.
    """

    # Physics.
    dt: float = DEFAULT_DT
    G: float = DEFAULT_G
    eps2: float = DEFAULT_EPS2
    # "verlet" | "euler" | "yoshida4" (ops/integrate.py).
    integrator: str = "verlet"

    # Force algorithm: "direct" (all pairs) | "pm" | "p3m" (not ported).
    method: str = "direct"
    pm_grid: int = 128
    boundary: str = "isolated"
    box_size: float = 0.0
    mesh_interlace: bool = False
    p3m_sigma_cells: float = 1.5
    p3m_rcut_sigmas: float = 4.5
    p3m_nbr_k: int = 32
    p3m_block: int = 0
    p3m_heavy_k: int = 16
    p3m_halo_tiles: int = 0
    cosmology: str = "none"
    omega_lambda: float = 0.7

    # Kernel selection.  backend: "auto" | "pallas" (the hand-written
    # kernels) | "jnp" (the plain oracle).  The names are the JAX
    # package's, kept so that configs interchange.
    backend: str = "auto"
    block_target: int = 2048
    block_source: int = 2048
    # "exact": one f32 all-pairs force kernel, then the integrator.
    # "sym": the fused Newton-3 step (each unordered pair evaluated once).
    # "fast": not ported.
    force_mode: str = "exact"
    # Re-sort bodies along the Morton curve every this many steps (0 =
    # never), at chunk boundaries.
    morton_every: int = 0
    fuse_integrate: bool = False
    fuse_epilogue: bool = True
    # The force VJP's precision: "precise" | "fast".  Checked by
    # ops/step.py, and both values run the same f32 CUDA kernels.  In the JAX package "fast" skips a
    # bf16 limb split of the MXU's weight matrices; CUDA cores do the
    # pair math in f32 and round no weights, so the port has one path.
    grad_precision: str = "precise"

    # Multi-device (not ported).
    mesh_axis: str = "x"
    strategy: str = "ring"

    # Misc.
    seed: int = 0
    size_factor: float = DEFAULT_SIZE_FACTOR

    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "SimConfig":
        d = json.loads(s)
        d.pop("__class__", None)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def log_slider_dt(value: float) -> float:
    """dt log-slider semantics: ``dt = 10**v``, v in [-5, -3]."""
    return math.pow(10.0, value)


def log_slider_G(value: float) -> float:
    """G log-slider semantics: ``G = 10**v``, v in [-6, 0]."""
    return math.pow(10.0, value)
