"""The forward kernels' wrappers and plain twins.

Four kernels (sources in ``nbody3d_tpu_torch/csrc/``, built by ``_build``):

==================  =========================================================
``force_exact``     all-pairs f32 force, targets x sources (exact mode)
``sym_diag_prep``   sym step 1: G-folded source rows + in-tile partials
``sym_hops``        sym step 2: off-diagonal tile pairs, both directions
``sym_epilogue_``   sym step 3: sum the partials, mask padding, Verlet
==================  =========================================================

Each wrapper checks its tensors (``ops/launch.py``: float32, ``(N, 4)``,
contiguous, one device, no autograd) and then takes its plain PyTorch twin
(``*_plain``) only because the tensors lie on the CPU; on a CUDA tensor it
launches the kernel on the current stream or raises.  The kernels allocate
nothing and do not synchronise.  Each launch adds one to the kernel's count
(``ops.launch.launch_counts``, shared with the VJP kernels of ``force_vjp``), so a
run can show that it went through the kernels.

The sym step keeps f32 vector accumulators in global memory:
``acc_diag`` (written by ``sym_diag_prep``) and ``acc_hop`` (zeroed by
the wrapper, summed into with atomics by ``sym_hops``).  Tile size ``b``
is the CUDA block size (one thread a body, ``b <= 1024``); ``nt = N / b``
tiles.  Any ``nt >= 2`` works: odd ``nt`` has no half hop, ``nt = 2`` only
the half hop.
"""

from __future__ import annotations

import torch

from nbody3d_tpu_torch.ops.integrate import apply_integrator, valid_mask
from nbody3d_tpu_torch.ops.launch import check_rows, check_tile, launch, lib, split_hops


# ------------------------------------------------------------ force_exact
def force_exact_plain(
    tgt: torch.Tensor, src: torch.Tensor, G: float, eps2: float, *, chunk: int = 1024
) -> torch.Tensor:
    """Plain twin of the ``force_exact`` kernel, chunked over targets.
    Pair terms are f32 as in the kernel; each row's sum is taken in f64
    and rounded once, so the twin carries no summation-order error of its
    own and a comparison measures the other side's."""
    gm = src[:, 3] * float(G)
    sx, sy, sz = src[:, 0], src[:, 1], src[:, 2]
    out = torch.zeros_like(tgt)
    for s in range(0, tgt.shape[0], chunk):
        t = tgt[s : s + chunk]
        dx = sx[None, :] - t[:, 0:1]
        dy = sy[None, :] - t[:, 1:2]
        dz = sz[None, :] - t[:, 2:3]
        d2 = dx * dx + (dy * dy + (dz * dz + eps2))
        w = gm[None, :] * torch.rsqrt(d2 * (d2 * d2))
        for c, d in enumerate((dx, dy, dz)):
            out[s : s + chunk, c] = torch.sum(w * d, dim=1, dtype=torch.float64).to(out.dtype)
    return out


def force_exact(tgt: torch.Tensor, src: torch.Tensor, G: float, eps2: float) -> torch.Tensor:
    """Softened accelerations of ``tgt`` rows against every ``src`` row
    (both ``(N, 4)`` pos_mass; G folds into the source masses in the
    kernel).  No self mask: a zero separation adds zero.  Returns
    ``(N_t, 4)``, w lane 0."""
    dev = check_rows("force_exact", tgt, src)
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0 (softening keeps the self pair finite)")
    if dev.type == "cpu":
        return force_exact_plain(tgt, src, G, eps2)
    out = torch.empty_like(tgt)
    launch(
        "force_exact", dev, lib().nb_force_exact,
        tgt, src, out, tgt.shape[0], src.shape[0], float(G), float(eps2),
    )
    return out


# ---------------------------------------------------------- sym_diag_prep
def sym_diag_prep_plain(
    pos_mass: torch.Tensor, G: float, eps2: float, b: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``sym_diag_prep``: ``(src, acc_diag)``."""
    n = pos_mass.shape[0]
    nt = n // b
    gm = pos_mass[:, 3:4] * float(G)
    src = torch.cat([pos_mass[:, :3], gm], dim=1)
    tiles = src.view(nt, b, 4)
    d = tiles[:, None, :, :3] - tiles[:, :, None, :3]  # (nt, t, s, 3): x_s - x_t
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d2 = dx * dx + (dy * dy + (dz * dz + eps2))
    w = tiles[:, None, :, 3] * torch.rsqrt(d2 * (d2 * d2))
    w = w * (1.0 - torch.eye(b, dtype=w.dtype, device=w.device))
    acc = torch.stack(
        [torch.sum(w * dx, dim=2), torch.sum(w * dy, dim=2), torch.sum(w * dz, dim=2),
         torch.zeros_like(dx[..., 0])],
        dim=2,
    ).reshape(n, 4)
    return src, acc


def sym_diag_prep(
    pos_mass: torch.Tensor, G: float, eps2: float, b: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sym step 1.  Returns ``(src, acc_diag)``: the G-folded source rows
    ``[x, y, z, G*m]`` and each tile's in-tile partial accelerations (all
    ordered pairs of the tile, self pair skipped), both ``(N, 4)``."""
    dev = check_rows("sym_diag_prep", pos_mass)
    nt = check_tile("sym_diag_prep", pos_mass.shape[0], b)
    if dev.type == "cpu":
        return sym_diag_prep_plain(pos_mass, G, eps2, b)
    src = torch.empty_like(pos_mass)
    acc = torch.empty_like(pos_mass)
    launch(
        "sym_diag_prep", dev, lib().nb_sym_diag_prep,
        pos_mass, src, acc, nt, b, float(G), float(eps2),
    )
    return src, acc


# --------------------------------------------------------------- sym_hops
def sym_hops_plain(src: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Plain twin of ``sym_hops``: ``acc_hop`` over the same pair sets."""
    n = src.shape[0]
    nt = n // b
    tiles = src.view(nt, b, 4)
    acc = torch.zeros((nt, b, 4), dtype=src.dtype, device=src.device)
    for k0, nk, grid_i in split_hops(nt):
        ii = torch.arange(grid_i, device=src.device)
        for k in range(k0, k0 + nk):
            jj = (ii + k) % nt
            ti, tj = tiles[ii], tiles[jj]  # (g, b, 4)
            d = tj[:, None, :, :3] - ti[:, :, None, :3]  # (g, t, s, 3)
            dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
            d2 = dx * dx + (dy * dy + (dz * dz + eps2))
            inv3 = torch.rsqrt(d2 * (d2 * d2))
            wf = tj[:, None, :, 3] * inv3
            wr = ti[:, :, None, 3] * inv3
            fwd = torch.stack(
                [torch.sum(wf * dx, 2), torch.sum(wf * dy, 2), torch.sum(wf * dz, 2)], dim=2
            )
            rev = -torch.stack(
                [torch.sum(wr * dx, 1), torch.sum(wr * dy, 1), torch.sum(wr * dz, 1)], dim=2
            )
            acc[:, :, :3].index_add_(0, ii, fwd)
            acc[:, :, :3].index_add_(0, jj, rev)
    return acc.view(n, 4)


def sym_hops(src: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Sym step 2.  Returns ``acc_hop (N, 4)``: for every unordered tile
    pair, the forward partial on the target tile and the reverse (Newton-3)
    partial on the source tile, each pair's weight computed once."""
    dev = check_rows("sym_hops", src)
    nt = check_tile("sym_hops", src.shape[0], b)
    if dev.type == "cpu":
        return sym_hops_plain(src, eps2, b)
    acc = torch.zeros_like(src)
    fn = lib().nb_sym_hops
    for k0, nk, grid_i in split_hops(nt):
        launch("sym_hops", dev, fn, src, acc, nt, b, k0, nk, grid_i, float(eps2))
    return acc


# ----------------------------------------------------------- sym_epilogue
def sym_epilogue_plain_(
    acc_diag: torch.Tensor,
    acc_hop: torch.Tensor,
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    n_real: int,
) -> None:
    """Plain twin of ``sym_epilogue_`` (same op order, in place)."""
    n = pos_mass.shape[0]
    valid = valid_mask(n, n_real, pos_mass.device)
    p, v, a = apply_integrator(
        "verlet", pos_mass, vel, accel, acc_diag + acc_hop, dt, valid
    )
    pos_mass.copy_(p)
    vel.copy_(v)
    accel.copy_(a)


def sym_epilogue_(
    acc_diag: torch.Tensor,
    acc_hop: torch.Tensor,
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    n_real: int,
) -> None:
    """Sym step 3, in place: ``a = acc_diag + acc_hop``; rows ``>= n_real``
    stay frozen with zero stored acceleration; the rest take the
    frame-shifted Verlet update, written into ``pos_mass``/``vel``/``accel``."""
    dev = check_rows("sym_epilogue", acc_diag, acc_hop, pos_mass, vel, accel)
    if len({t.shape for t in (acc_diag, acc_hop, pos_mass, vel, accel)}) != 1:
        raise ValueError("sym_epilogue: all five tensors must have one shape")
    if dev.type == "cpu":
        sym_epilogue_plain_(acc_diag, acc_hop, pos_mass, vel, accel, dt, n_real)
        return
    n = pos_mass.shape[0]
    launch(
        "sym_epilogue", dev, lib().nb_sym_epilogue,
        acc_diag, acc_hop, pos_mass, vel, accel, n, min(int(n_real), n),
        float(dt),
    )


def sym_step_(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    G: float,
    *,
    eps2: float,
    b: int,
    n_real: int,
) -> None:
    """The fused Newton-3 Verlet step (``sym_verlet_step_pallas``'s
    counterpart): diag_prep -> hops -> epilogue, updating the state in
    place."""
    src, acc_diag = sym_diag_prep(pos_mass, G, eps2, b)
    acc_hop = sym_hops(src, eps2, b)
    sym_epilogue_(acc_diag, acc_hop, pos_mass, vel, accel, dt, n_real)
