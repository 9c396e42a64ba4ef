"""The mesh kernels' wrappers and plain twins, and the mesh long-range legs.

The counterpart of ``nbody3d_tpu/ops/mesh_pallas.py`` as ``cuda_force`` is
that of ``pallas_force``.  Two kernels (sources in
``nbody3d_tpu_torch/csrc/``, built by ``_build``):

================  ==========================================================
``mesh_deposit``  TSC (order 3) or CIC (order 2) mass deposit onto a
                  ``(G, G, G)`` grid: a block's 256 particles into a box
                  (or a window of it) in shared memory, flushed with one
                  ``atomicAdd`` a cell, the rest with global atomics of
                  four cells each
``mesh_gather``   interpolation of the 3 force grids at the particles with
                  the same assignment function: for rows in Morton order
                  a block's 256 particles read their stencils from a box
                  of the grids staged in shared memory (or, a box too
                  large, from the grids); other rows a thread a particle
================  ==========================================================

Both take the per-particle operands ``c4 (N, 4) int32`` (the stencil's
base cell ``[cx, cy, cz, 0]``) and ``fm (N, 4) float32`` (the fractional
offset and the mass ``[fx, fy, fz, m]``), made by :func:`mesh_operands`
from the cells of ``p3m._tsc_cells`` or ``pm._cic_cells``.  The kernel and
its twin build the weights from the same ``f``.  On the isolated box the
cells are clipped so that the whole stencil lies inside the grid, which
the wrappers take as given; on the periodic box (``periodic=True``) the
base cell lies in ``[0, G)`` and every stencil index wraps mod ``G`` in
all three axes, at both orders.  (The TPU kernels wrap z in-kernel and
x/y through halo pads, TSC only; the port's PM runs CIC on these kernels
too.)

The TPU kernels deposit per Morton tile into a box of the grid held in
VMEM and send the particles outside their tile's box to an XLA repair pass
with a fixed budget of tiles.  On the card the deposit keeps the box (one
per block, in shared memory, over a run of 256 consecutive particles) but
not the budget: the particles outside a block's box (or the window of it
that fits) deposit with global atomics in the same launch, so every
particle is deposited in the one pass and there is no repair.  Any order
is right; Morton-sorted rows (P3M's) give small boxes, and PM's unsorted
rows a window on their densest region.

The wrappers launch the kernels on a CUDA tensor and take the twins only
for a CPU tensor.  ``p3m.accel_p3m`` and ``pm.accel_pm`` run deposit, FFT
solve and gather through :func:`deposit_diff` and :func:`gather_diff`,
autograd Functions whose backwards are :func:`deposit_vjp` and
:func:`gather_vjp` (the JAX package differentiates its XLA forms there:
``jax.vjp`` of ``mesh_accel_jnp``, ``mesh_pallas.py:878-886``, and PM's
autodiff); their ``backend="jnp"`` runs the twins on any device, and
autograd goes through them.  The VJPs run the kernels for the scatter (the
grid cotangent of the gather is a deposit of its output's cotangent, one
component at a time) and torch ops for the stencil's derivative weights;
no TPU kernel has a backward of its own here.  On the periodic box the
VJPs wrap every stencil index as the forwards do, and the grids'
cotangent is the periodic deposit (the JAX package takes ``jax.vjp`` of
``mesh_accel_periodic_jnp`` there, ``mesh_pallas.py:796-822``).
"""

from __future__ import annotations

import torch

from nbody3d_tpu_torch.ops.launch import check_rows, launch, lib
from nbody3d_tpu_torch.utils.profiling import span

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


def axis_slopes(f: torch.Tensor, order: int) -> tuple[torch.Tensor, ...]:
    """d/df of :func:`axis_weights`: TSC ``{-(0.5-f), -2f, 0.5+f}``, CIC
    ``{-1, 1}``."""
    if order == 3:
        return f - 0.5, -2.0 * f, 0.5 + f
    return -torch.ones_like(f), torch.ones_like(f)


def _offsets(order: int) -> tuple[int, ...]:
    return (-1, 0, 1) if order == 3 else (0, 1)


def _stencil(c: torch.Tensor, f: torch.Tensor, grid: int, order: int, mass=None, periodic: bool = False):
    """``(flat cell index (N,), weight (N,))`` of each stencil point, in the
    kernels' order (x outermost, z innermost).  The weight is
    ``((m·wx)·wy)·wz``, or ``(wx·wy)·wz`` without ``mass``, as the kernels
    and the JAX package multiply.  ``periodic``: each axis index mod
    ``grid``."""
    w = axis_weights(f, order)

    def cell(axis, off):
        v = c[:, axis] + off
        return torch.remainder(v, grid) if periodic else v

    for a, dx in enumerate(_offsets(order)):
        for b, dy in enumerate(_offsets(order)):
            for d, dz in enumerate(_offsets(order)):
                idx = (cell(0, dx) * grid + cell(1, dy)) * grid + cell(2, dz)
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
    # The kernels take float32; the twins (CPU tensors) float64 too, for gradcheck.
    dev = check_rows(name, fm, dtype=fm.dtype if fm.device.type == "cpu" and fm.dtype == torch.float64
                     else torch.float32)
    check_rows(name, c4, dtype=torch.int32)
    if c4.shape[0] != fm.shape[0] or c4.device != dev:
        raise ValueError(f"{name}: c4 {tuple(c4.shape)} on {c4.device}, fm {tuple(fm.shape)} on {dev}")
    if order not in (2, 3):
        raise ValueError(f"{name}: order must be 2 or 3, got {order}")
    if not 4 <= grid <= 1290:  # grid**3 indexes in int32
        raise ValueError(f"{name}: grid {grid} out of range")
    return dev


def _check_paths(name: str, block_paths: torch.Tensor | None, n: int, dev: torch.device) -> None:
    if block_paths is not None and (block_paths.dtype != torch.int32 or tuple(block_paths.shape) != (n,)
                                    or block_paths.device != dev):
        raise ValueError(f"{name}: block_paths must be an int32 ({n},) tensor on the card")


# ----------------------------------------------------------- mesh_deposit
def deposit_plain(c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int, periodic: bool = False) -> torch.Tensor:
    """Plain twin of ``mesh_deposit``: every stencil point's ``m·wx·wy·wz``
    summed into its cell with one ``index_add_``."""
    idx, val = zip(*_stencil(c4, fm[:, :3], grid, order, mass=fm[:, 3], periodic=periodic))
    rho = torch.zeros(grid**3, dtype=fm.dtype, device=fm.device)
    rho.index_add_(0, torch.cat(idx), torch.cat(val))
    return rho.view(grid, grid, grid)


def deposit(c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int, periodic: bool = False, *,
            block_paths: torch.Tensor | None = None) -> torch.Tensor:
    """Mass deposit → ``(grid, grid, grid)`` (mass per cell), on the torus
    when ``periodic``.  On the card the atomics add in no fixed order, so
    two runs agree to f32 rounding, not bit for bit.  ``block_paths``: an
    int32 ``(3,)`` tensor on the card to which the kernel adds its blocks
    that took the whole box, a window of it, and global atomics alone
    (``csrc/mesh_deposit.cu``); the twin leaves it alone."""
    dev = _check("mesh_deposit", c4, fm, grid, order)
    if dev.type == "cpu":
        return deposit_plain(c4, fm, grid, order, periodic)
    _check_paths("mesh_deposit", block_paths, 3, dev)
    rho = torch.zeros((grid, grid, grid), dtype=torch.float32, device=dev)
    launch("mesh_deposit", dev, lib().nb_mesh_deposit, c4, fm, rho, c4.shape[0], grid, order, int(periodic),
           block_paths)
    return rho


# ------------------------------------------------------------ mesh_gather
def gather_plain(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int,
                 periodic: bool = False) -> torch.Tensor:
    """Plain twin of ``mesh_gather``: ``(N, 4)``, w lane 0."""
    out = torch.zeros_like(fm)
    for idx, w in _stencil(c4, fm[:, :3], grid, order, periodic=periodic):
        out[:, :3] += grids[:, idx].T * w[:, None]
    return out


def gather(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int,
           periodic: bool = False, sorted_rows: bool = True, *,
           block_paths: torch.Tensor | None = None) -> torch.Tensor:
    """Interpolation of ``grids (3, G³)`` at the particles → ``(N, 4)``,
    w lane 0 (the mass lane of ``fm`` is not read), on the torus when
    ``periodic``.  ``sorted_rows``: the rows come in Morton order (P3M's),
    so the kernel stages each run's box of the grids in shared memory;
    ``False`` (PM's unsorted rows) takes its loop alone, which needs the
    L1 the boxes would hold.  Any rows give the same bits either way.
    ``block_paths``: an int32 ``(2,)`` tensor on the card to which the
    kernel adds its blocks (runs of 256 rows) that read a box in shared
    memory and those that read the grids in global memory
    (``csrc/mesh_gather.cu``); the twin leaves it alone."""
    dev = _check("mesh_gather", c4, fm, grid, order)
    if grids.dtype != fm.dtype or tuple(grids.shape) != (3, grid**3) or not grids.is_contiguous():
        raise ValueError(f"mesh_gather: grids must be contiguous {fm.dtype} (3, {grid**3}), got "
                         f"{grids.dtype} {tuple(grids.shape)}")
    if grids.device != dev or grids.requires_grad:
        raise ValueError("mesh_gather: grids on another device or requiring grad")
    if dev.type == "cpu":
        return gather_plain(grids, c4, fm, grid, order, periodic)
    _check_paths("mesh_gather", block_paths, 2, dev)
    out = torch.empty_like(fm)
    launch("mesh_gather", dev, lib().nb_mesh_gather, grids, c4, fm, out, c4.shape[0], grid, order, int(periodic),
           int(sorted_rows), block_paths)
    return out


# ------------------------------------------------------------ the VJPs
def _stencil_sums(values, c4: torch.Tensor, f: torch.Tensor, grid: int, order: int, periodic: bool = False):
    """``(Σ w·v (N,), Σ ∂w/∂f·v (N, 3))`` over each particle's stencil, with
    ``v = values(idx)`` the ``(N, Z)`` values at the flat cells ``idx``
    of a z-row of the stencil: the interpolation and its slope along each
    axis.  ``periodic``: each axis index mod ``grid``, as :func:`_stencil`."""
    w, dw = axis_weights(f, order), axis_slopes(f, order)
    offs = _offsets(order)
    dz = torch.tensor(offs, device=c4.device)
    wz, dwz = torch.stack([x[:, 2] for x in w], 1), torch.stack([x[:, 2] for x in dw], 1)
    interp = torch.zeros(f.shape[0], dtype=f.dtype, device=f.device)
    slope = torch.zeros_like(f)
    c = c4[:, :3].long()
    z = c[:, 2:3] + dz
    if periodic:
        z = torch.remainder(z, grid)
    for a, dx in enumerate(offs):
        for b, dy in enumerate(offs):
            x, y = c[:, 0] + dx, c[:, 1] + dy
            if periodic:
                x, y = torch.remainder(x, grid), torch.remainder(y, grid)
            v = values(((x * grid + y) * grid)[:, None] + z)
            vz, vdz = torch.sum(v * wz, dim=1), torch.sum(v * dwz, dim=1)
            wx, wy, dwx, dwy = w[a][:, 0], w[b][:, 1], dw[a][:, 0], dw[b][:, 1]
            interp += vz * wx * wy
            slope[:, 0] += vz * dwx * wy
            slope[:, 1] += vz * wx * dwy
            slope[:, 2] += vdz * wx * wy
    return interp, slope


def deposit_vjp(c4: torch.Tensor, fm: torch.Tensor, rho_bar: torch.Tensor, grid: int, order: int,
                periodic: bool = False) -> torch.Tensor:
    """The VJP of the deposit for the cotangent ``rho_bar (grid, grid,
    grid)``: ``fm_bar (N, 4)``, the fractions' ``m · Σ ∂w/∂f · rho_bar``
    and the mass's interpolation of ``rho_bar``, on the torus when
    ``periodic``."""
    flat = rho_bar.reshape(-1)
    m_bar, slope = _stencil_sums(lambda idx: flat[idx], c4, fm[:, :3], grid, order, periodic)
    return torch.cat([fm[:, 3:4] * slope, m_bar[:, None]], dim=1)


def gather_vjp(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, out_bar: torch.Tensor, grid: int,
               order: int, periodic: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The VJP of the gather for its output's cotangent ``out_bar (N, 4)``
    (w lane not read): ``(grids_bar (3, G³), fm_bar (N, 4))``.  Each grid's
    cotangent is the deposit of one lane of ``out_bar`` (``mesh_deposit``
    on a card, in its periodic form when ``periodic``); the fractions' is
    ``Σ ∂w/∂f · (out_bar · grids)``, the mass's 0."""
    gbar = out_bar[:, :3]
    f = fm[:, :3].contiguous()
    grids_bar = torch.stack([
        deposit(c4, torch.cat([f, gbar[:, i : i + 1]], 1).contiguous(), grid, order, periodic).view(-1)
        for i in range(3)
    ])
    # A product and a sum over the 3 lanes: as an einsum, cuBLAS runs N
    # (Z, 3) x (3,) GEMVs, 27 ms a TSC backward at 2M on an H100.
    _, slope = _stencil_sums(lambda idx: torch.sum(grids[:, idx] * gbar.T[:, :, None], dim=0), c4, f, grid, order,
                             periodic)
    return grids_bar, torch.cat([slope, torch.zeros_like(slope[:, :1])], dim=1)


class _Deposit(torch.autograd.Function):
    """:func:`deposit` with :func:`deposit_vjp` as its backward (by ``fm``),
    on the torus when ``periodic``."""

    @staticmethod
    def forward(ctx, c4, fm, grid, order, periodic):
        ctx.save_for_backward(c4, fm)
        ctx.opts = (grid, order, periodic)
        return deposit(c4, fm.detach(), grid, order, periodic)

    @staticmethod
    def backward(ctx, rho_bar):
        c4, fm = ctx.saved_tensors
        with span("nbody3d.vjp"):
            return None, deposit_vjp(c4, fm.detach(), rho_bar, *ctx.opts), None, None, None


class _Gather(torch.autograd.Function):
    """:func:`gather` with :func:`gather_vjp` as its backward (by ``grids``
    and ``fm``), on the torus when ``periodic``; the wrapper gets detached
    grids."""

    @staticmethod
    def forward(ctx, grids, c4, fm, grid, order, periodic, sorted_rows):
        ctx.save_for_backward(grids, c4, fm)
        ctx.opts = (grid, order, periodic)
        return gather(grids.detach(), c4, fm.detach(), grid, order, periodic, sorted_rows)

    @staticmethod
    def backward(ctx, out_bar):
        grids, c4, fm = ctx.saved_tensors
        with span("nbody3d.vjp"):
            grids_bar, fm_bar = gather_vjp(grids.detach(), c4, fm.detach(), out_bar, *ctx.opts)
        return grids_bar, None, fm_bar, None, None, None, None


def deposit_diff(c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int, periodic: bool = False) -> torch.Tensor:
    """:func:`deposit`, differentiable in ``fm`` (fractions and mass), on
    the isolated or (``periodic``) the periodic box."""
    return _Deposit.apply(c4, fm, grid, order, periodic)


def gather_diff(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int,
                periodic: bool = False, sorted_rows: bool = True) -> torch.Tensor:
    """:func:`gather`, differentiable in ``grids`` and ``fm``, on the
    isolated or (``periodic``) the periodic box."""
    return _Gather.apply(grids, c4, fm, grid, order, periodic, sorted_rows)
