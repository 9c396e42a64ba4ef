"""Simulation configuration, shared field for field with ``nbody3d_tpu``.

``SimConfig`` keeps the JAX package's field names, defaults and JSON
(``to_json``/``from_json``), so a config written by either package loads
in the other.

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
    (``"direct"``, ``"pm"`` or ``"p3m"``), ``pm_grid``,
    ``p3m_sigma_cells``, ``p3m_rcut_sigmas``, ``p3m_nbr_k``,
    ``p3m_block``, ``p3m_heavy_k``, ``boundary`` (``"isolated"``, or
    ``"periodic"`` with a mesh method), ``box_size`` and
    ``mesh_interlace`` (periodic), ``cosmology`` (``"none"``, or
    ``"eds"``/``"lcdm"`` on the periodic mesh solvers with Verlet: the
    comoving step of ``ops/expansion.py``), ``omega_lambda`` (``"lcdm"``),
    ``backend``, ``block_target`` (capped at the GPU tile), ``force_mode`` (``"exact"``, ``"fast"`` or ``"sym"``,
    direct only), ``morton_every``, ``fuse_integrate`` (exact or fast with
    Verlet, whose steps that need no gradient always run the one-launch
    force + Verlet kernel: ``True`` refuses a gradient, as the JAX
    package's fused step has none, where ``False`` routes it through the
    force and the torch Verlet), ``fuse_epilogue``,
    ``grad_precision``, ``seed``, ``size_factor``, and on a mesh
    (``parallel/``) ``strategy``, ``mesh_axis`` and ``p3m_halo_tiles`` (the
    sharded P3M step's halo capacity in remote tiles a rank; 0 picks
    ``max(2·tiles_per, 4·nbr_k, 64)``, as in the JAX package).
    """

    # Physics.
    dt: float = DEFAULT_DT
    G: float = DEFAULT_G
    eps2: float = DEFAULT_EPS2
    # "verlet" | "euler" | "yoshida4" (ops/integrate.py).
    integrator: str = "verlet"

    # Force algorithm: "direct" (all pairs) | "pm" | "p3m" (mesh solvers).
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
    # "sym": Newton-3 (each unordered pair evaluated once): the fused step
    # with Verlet, the sym force and the integrator otherwise.
    # "fast": bf16 weights on the tensor cores against 3-limb sources
    # (force_fast, fused_step_fast); the bf16 weight noise is held within
    # 5e-3 of the force's scale.
    force_mode: str = "exact"
    # Re-sort bodies along the Morton curve every this many steps (0 =
    # never), at chunk boundaries.
    morton_every: int = 0
    fuse_integrate: bool = False
    fuse_epilogue: bool = True
    # The force VJP's precision: "precise" | "fast".  Checked by
    # ops/step.py, and both values run the same f32 CUDA kernels.  In the JAX package "fast" skips a
    # bf16 limb split of the MXU's weight matrices; the port's VJP kernels
    # do the pair math in f32 on CUDA cores and round no weights, so it has
    # one path.  (Only the forward of force_mode="fast" rounds weights.)
    grad_precision: str = "precise"

    # Multi-device (parallel/sharded.py): the 1-D mesh's axis, and the
    # exchange: "ring" | "ringsym" | "gather" | "2d".
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
