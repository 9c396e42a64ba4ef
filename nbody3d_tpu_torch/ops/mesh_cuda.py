"""The mesh kernels' wrappers and plain twins, and the mesh long-range legs.

The counterpart of ``nbody3d_tpu/ops/mesh_pallas.py`` as ``cuda_force`` is
that of ``pallas_force``.  Two kernels (sources in
``nbody3d_tpu_torch/csrc/``, built by ``_build``):

================  ==========================================================
``mesh_deposit``  TSC (order 3) or CIC (order 2) mass deposit onto a
                  ``(G, G, G)`` grid: one thread a particle, ``atomicAdd``
``mesh_gather``   interpolation of the 3 force grids at the particles with
                  the same assignment function: one thread a particle
================  ==========================================================

Both take the per-particle operands ``c4 (N, 4) int32`` (the stencil's
base cell ``[cx, cy, cz, 0]``) and ``fm (N, 4) float32`` (the fractional
offset and the mass ``[fx, fy, fz, m]``), made by :func:`mesh_operands`
from the cells of ``p3m._tsc_cells`` or ``pm._cic_cells``.  The kernel and
its twin build the weights from the same ``f``.  The cells are clipped so
that the whole stencil lies inside the grid, which the wrappers take as
given.

The TPU kernels deposit per Morton tile into a box of the grid held in
VMEM and send the particles outside their tile's box to an XLA repair pass
with a fixed budget of tiles.  On the card every particle is deposited in
the one pass, so there are no tiles, boxes, corners or repair here, and
PM needs no Morton sort.

The wrappers launch the kernels on a CUDA tensor and take the twins only
for a CPU tensor.  ``p3m.accel_p3m`` and ``pm.accel_pm`` run deposit, FFT
solve and gather; their ``backend="jnp"`` runs the twins on any device.
"""

from __future__ import annotations

import torch

from nbody3d_tpu_torch.ops.launch import check_rows, launch, lib


def axis_weights(f: torch.Tensor, order: int) -> tuple[torch.Tensor, ...]:
    """Per-axis assignment weights at the stencil offsets (``_offsets``),
    each ``(N, 3)``: TSC ``{0.5(0.5-f)², 0.75-f², 0.5(0.5+f)²}`` at
    -1/0/+1 from ``f`` in [-1/2, 1/2] (``mesh_pallas._axis_weights``), CIC
    ``{1-f, f}`` at 0/+1 from ``f`` in [0, 1]."""
    if order == 3:
        return 0.5 * (0.5 - f) ** 2, 0.75 - f * f, 0.5 * (0.5 + f) ** 2
    if order == 2:
        return 1.0 - f, f
    raise ValueError(f"assignment order must be 2 (CIC) or 3 (TSC), got {order}")


def _offsets(order: int) -> tuple[int, ...]:
    return (-1, 0, 1) if order == 3 else (0, 1)


def _stencil(c: torch.Tensor, f: torch.Tensor, grid: int, order: int, mass=None):
    """``(flat cell index (N,), weight (N,))`` of each stencil point, in the
    kernels' order (x outermost, z innermost).  The weight is
    ``((m·wx)·wy)·wz``, or ``(wx·wy)·wz`` without ``mass``, as the kernels
    and the JAX package multiply."""
    w = axis_weights(f, order)
    for a, dx in enumerate(_offsets(order)):
        for b, dy in enumerate(_offsets(order)):
            for d, dz in enumerate(_offsets(order)):
                idx = ((c[:, 0] + dx) * grid + (c[:, 1] + dy)) * grid + (c[:, 2] + dz)
                wx = w[a][:, 0] if mass is None else mass * w[a][:, 0]
                yield idx.long(), wx * w[b][:, 1] * w[d][:, 2]


def mesh_operands(c: torch.Tensor, f: torch.Tensor, mass: torch.Tensor | None = None):
    """``(c4, fm)``: the kernels' ``(N, 4)`` operands from cells ``c (N, 3)``,
    fractions ``f (N, 3)`` and ``mass (N,)`` (zeros when None)."""
    n = c.shape[0]
    c4 = torch.cat([c.to(torch.int32), torch.zeros((n, 1), dtype=torch.int32, device=c.device)], 1)
    m = torch.zeros((n,), dtype=f.dtype, device=f.device) if mass is None else mass
    return c4.contiguous(), torch.cat([f, m[:, None]], 1).contiguous()


def _check(name: str, c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int) -> torch.device:
    dev = check_rows(name, fm)
    check_rows(name, c4, dtype=torch.int32)
    if c4.shape[0] != fm.shape[0] or c4.device != dev:
        raise ValueError(f"{name}: c4 {tuple(c4.shape)} on {c4.device}, fm {tuple(fm.shape)} on {dev}")
    if order not in (2, 3):
        raise ValueError(f"{name}: order must be 2 or 3, got {order}")
    if not 4 <= grid <= 1290:  # grid**3 indexes in int32
        raise ValueError(f"{name}: grid {grid} out of range")
    return dev


# ----------------------------------------------------------- mesh_deposit
def deposit_plain(c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int) -> torch.Tensor:
    """Plain twin of ``mesh_deposit``: every stencil point's ``m·wx·wy·wz``
    summed into its cell with one ``index_add_``."""
    idx, val = zip(*_stencil(c4, fm[:, :3], grid, order, mass=fm[:, 3]))
    rho = torch.zeros(grid**3, dtype=fm.dtype, device=fm.device)
    rho.index_add_(0, torch.cat(idx), torch.cat(val))
    return rho.view(grid, grid, grid)


def deposit(c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int) -> torch.Tensor:
    """Mass deposit → ``(grid, grid, grid)`` (mass per cell).  On the card
    the atomics add in no fixed order, so two runs agree to f32 rounding,
    not bit for bit."""
    dev = _check("mesh_deposit", c4, fm, grid, order)
    if dev.type == "cpu":
        return deposit_plain(c4, fm, grid, order)
    rho = torch.zeros((grid, grid, grid), dtype=torch.float32, device=dev)
    launch("mesh_deposit", dev, lib().nb_mesh_deposit, c4, fm, rho, c4.shape[0], grid, order)
    return rho


# ------------------------------------------------------------ mesh_gather
def gather_plain(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int) -> torch.Tensor:
    """Plain twin of ``mesh_gather``: ``(N, 4)``, w lane 0."""
    out = torch.zeros_like(fm)
    for idx, w in _stencil(c4, fm[:, :3], grid, order):
        out[:, :3] += grids[:, idx].T * w[:, None]
    return out


def gather(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int) -> torch.Tensor:
    """Interpolation of ``grids (3, G³)`` at the particles → ``(N, 4)``,
    w lane 0 (the mass lane of ``fm`` is not read)."""
    dev = _check("mesh_gather", c4, fm, grid, order)
    if grids.dtype != torch.float32 or tuple(grids.shape) != (3, grid**3) or not grids.is_contiguous():
        raise ValueError(f"mesh_gather: grids must be contiguous float32 (3, {grid**3}), got "
                         f"{grids.dtype} {tuple(grids.shape)}")
    if grids.device != dev or grids.requires_grad:
        raise ValueError("mesh_gather: grids on another device or requiring grad")
    if dev.type == "cpu":
        return gather_plain(grids, c4, fm, grid, order)
    out = torch.empty_like(fm)
    launch("mesh_gather", dev, lib().nb_mesh_gather, grids, c4, fm, out, c4.shape[0], grid, order)
    return out

