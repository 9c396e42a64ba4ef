"""Particle-mesh (PM) gravity: ``nbody3d_tpu/ops/pm.py``.

Pipeline of one force evaluation:

1. a cubic box from the real bodies' bounds, every step (``h`` and ``lo``
   are device tensors: nothing is rebuilt as the system expands);
2. cloud-in-cell (CIC) mass deposit onto an ``(M, M, M)`` grid
   (``mesh_cuda.deposit`` at order 2; the twin :func:`cic_deposit` sums
   with ``index_add_``);
3. the isolated Poisson solve by zero-padded FFT convolution with the
   Plummer-softened potential ``-1/sqrt(r² + eps2)`` on the ``(2M)³`` grid;
4. central-difference force grids;
5. CIC interpolation at the bodies (``mesh_cuda.gather``), times ``G``.

The JAX package deposits without a scatter (a sort and a segmented scan,
``deposit_cols``/``_segment_sum_*``), because a scatter is serial on the
TPU; the card has atomics, so the port needs neither.

``boundary="periodic"`` (``box_size > 0``) solves on the torus ``[0, L)³``
instead: the fixed cell ``h = L/M``, positions wrapped, the CIC stencil
wrapped mod ``M`` in the kernels, and one spectral solve
(``ewald.spectral_accel_grids`` with Gaussian smoothing 1.5 cells;
``eps2`` does not enter), optionally two half-cell-shifted legs averaged
(``interlace``).  Gradients flow through it as through the isolated
form (``mesh_cuda``'s periodic VJPs, autograd through the wrap and the
solve).
"""

from __future__ import annotations

import functools

import torch

from nbody3d_tpu_torch.ops import mesh_cuda
from nbody3d_tpu_torch.ops.ewald import wrap_box

# Bodies stay this many cells clear of the grid faces, so that no stencil
# and no central difference reaches a face.
_EDGE_CELLS = 3

DEFAULT_PM_GRID = 128
# The periodic solve's Gaussian smoothing in cells (the JAX accel_pm's
# sigma_cells default, which no caller changes).
PERIODIC_SIGMA_CELLS = 1.5


def box_from_bounds(lo_w: torch.Tensor, hi_w: torch.Tensor, grid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cubic grid placement ``(lo (3,), h ())`` from world bounds, with every
    body at least ``_EDGE_CELLS`` cells from each face."""
    center = 0.5 * (lo_w + hi_w)
    half = torch.clamp(torch.max(hi_w - lo_w) * 0.5, min=1e-6)
    h = (2.0 * half) / float(grid - 2 * _EDGE_CELLS - 1)
    lo = center - h * float(grid) * 0.5
    return lo, h


def _box(pos_real: torch.Tensor, grid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The box of one device's real bodies (device tensors, no host sync)."""
    return box_from_bounds(torch.amin(pos_real, dim=0), torch.amax(pos_real, dim=0), grid)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``torch.clamp``'s values, with JAX's gradient, which a
    ``maximum`` and a ``minimum`` split in half at a bound (a body exactly
    on a cell face has ``f = 0``).  The bounds are filled on ``x``'s device
    (a copy from the host would wait for the device)."""
    return torch.minimum(torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device)),
                         torch.full((), hi, dtype=x.dtype, device=x.device))


def _cic_cells(pos: torch.Tensor, lo: torch.Tensor, h: torch.Tensor, grid: int, periodic: bool = False):
    """CIC base cell ``i0 (N, 3) int32`` in [0, grid-2] and fraction ``f``
    in [0, 1], with cell values at the centres ``lo + (i + 0.5) h``.
    ``periodic``: ``i0`` in [0, grid-1] (mod ``grid``; the +1 neighbour
    wraps in the kernels), ``f`` against the unwrapped cell."""
    s = (pos - lo) / h - 0.5
    if periodic:
        raw = torch.floor(s)
        return torch.remainder(raw.to(torch.int32), grid), clip(s - raw, 0.0, 1.0)
    i0 = torch.clamp(torch.floor(s).to(torch.int32), 0, grid - 2)
    f = clip(s - i0.to(s.dtype), 0.0, 1.0)
    return i0, f


def cic_deposit(pos: torch.Tensor, mass: torch.Tensor, lo: torch.Tensor, h: torch.Tensor, grid: int) -> torch.Tensor:
    """CIC mass deposit → ``(grid, grid, grid)``, mass per cell (the twin
    of ``mesh_deposit`` at order 2)."""
    i0, f = _cic_cells(pos, lo, h, grid)
    return mesh_cuda.deposit_plain(*mesh_cuda.mesh_operands(i0, f, mass), grid, 2)


def _offset_axis(m2: int, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx, d)``: the padded grid's index and its signed separation
    ``d = idx·h`` (``idx <= m``) or ``(idx - 2m)·h``."""
    idx = torch.arange(m2, device=h.device)
    m = m2 // 2
    d = torch.where(idx <= m, idx, idx - m2).to(torch.float32) * h
    return idx, d


def _pad(rho: torch.Tensor) -> torch.Tensor:
    m = rho.shape[0]
    return torch.nn.functional.pad(rho, (0, m, 0, m, 0, m))


def solve_potential(rho: torch.Tensor, h: torch.Tensor, eps2: float) -> torch.Tensor:
    """Isolated potential per unit G, ``Φ/G = Σ_j m_j · (-1/sqrt(r² + eps2))``,
    by zero-padded FFT convolution → ``(M, M, M)``."""
    m = rho.shape[0]
    m2 = 2 * m
    _, d = _offset_axis(m2, h)
    r2 = d[:, None, None] ** 2 + d[None, :, None] ** 2 + d[None, None, :] ** 2 + eps2
    kern = -torch.rsqrt(r2)
    phi = torch.fft.irfftn(torch.fft.rfftn(_pad(rho)) * torch.fft.rfftn(kern), s=(m2, m2, m2))
    return phi[:m, :m, :m]


def force_grids(phi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Central-difference ``a = -∇Φ`` → ``(3, M³)``.  The face cells wrap
    but are never read (the box keeps bodies ``_EDGE_CELLS`` inside)."""
    inv2h = 0.5 / h
    comps = [(torch.roll(phi, 1, axis) - torch.roll(phi, -1, axis)) * inv2h for axis in (0, 1, 2)]
    return torch.stack([c.reshape(-1) for c in comps], dim=0)


def cic_gather(grids: torch.Tensor, i0: torch.Tensor, f: torch.Tensor, grid: int) -> torch.Tensor:
    """Trilinear interpolation of ``(3, M³)`` grids → ``(N, 3)`` (the twin
    of ``mesh_gather`` at order 2)."""
    return mesh_cuda.gather_plain(grids, *mesh_cuda.mesh_operands(i0, f), grid, 2)[:, :3]


def accel_pm(
    pos_mass: torch.Tensor,
    G: float | torch.Tensor,
    *,
    grid: int = DEFAULT_PM_GRID,
    eps2: float = 1e-4,
    n_real: int | None = None,
    mesh_backend: str = "auto",
    boundary: str = "isolated",
    box_size: float = 0.0,
    interlace: bool = False,
) -> torch.Tensor:
    """PM accelerations ``(N, 4)`` (w lane 0) with an isolated boundary,
    differentiable in ``pos_mass`` and ``G`` (autograd through the box, the
    FFT solve and the central differences, as the JAX package's autodiff).
    ``mesh_backend="jnp"`` runs the plain twins; otherwise the deposit and
    gather go through ``mesh_cuda.deposit_diff``/``gather_diff`` (the
    kernels on a card, with their VJPs as backwards).

    ``boundary="periodic"`` (``box_size > 0``): the torus of side
    ``box_size``, one CIC mesh leg (two averaged with ``interlace``) with
    the spectral solve at Gaussian width ``PERIODIC_SIGMA_CELLS`` cells,
    differentiable in the same way."""
    n = pos_mass.shape[0]
    n_real = n if n_real is None else n_real
    if boundary == "periodic":
        return _accel_pm_periodic(pos_mass, G, grid, mesh_backend == "jnp", box_size, interlace)
    if boundary != "isolated":
        raise ValueError(f"unknown boundary {boundary!r}")
    lo, h = _box(pos_mass[:n_real, :3], grid)
    i0, f = _cic_cells(pos_mass[:, :3], lo, h, grid)
    c4, fm = mesh_cuda.mesh_operands(i0, f, pos_mass[:, 3])
    plain = mesh_backend == "jnp"
    dep, gat = ((mesh_cuda.deposit_plain, mesh_cuda.gather_plain) if plain
                else (mesh_cuda.deposit_diff, functools.partial(mesh_cuda.gather_diff, sorted_rows=False)))
    phi = solve_potential(dep(c4, fm, grid, 2), h, eps2)
    return gat(force_grids(phi, h), c4, fm, grid, 2) * G


def _accel_pm_periodic(pos_mass, G, grid, plain, box_size, interlace):
    """Periodic PM (``nbody3d_tpu/ops/pm.py:323-350``)."""
    from nbody3d_tpu_torch.ops.p3m import periodic_mesh_leg  # p3m imports this module

    if box_size <= 0:
        raise ValueError("boundary='periodic' requires box_size > 0")
    L = torch.tensor(box_size, dtype=torch.float32, device=pos_mass.device)
    h = L / grid
    sigma = PERIODIC_SIGMA_CELLS * h
    pos, mass = wrap_box(pos_mass[:, :3], L), pos_mass[:, 3]
    acc = periodic_mesh_leg(pos, mass, L, sigma, grid, 2, plain, sorted_rows=False)
    if interlace:
        acc = 0.5 * (acc + periodic_mesh_leg(wrap_box(pos + 0.5 * h, L), mass, L, sigma, grid, 2, plain,
                                             sorted_rows=False))
    return acc * G
