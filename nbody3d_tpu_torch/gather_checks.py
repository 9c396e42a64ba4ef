"""The gather kernel's seam scenes, and a mirror of its run boxes.

For rows in Morton order ``csrc/mesh_gather.cu`` gathers each run of
:data:`RUN` consecutive particles from a box of the grids in shared memory
when the box holds at most :data:`BOX_CAP` cells, else from the grids in
global memory; on the periodic box each base cell is first unwrapped to the
image nearest the run's first particle.  Other rows take the global loop
alone.  :func:`run_boxes` mirrors those decisions in torch,
:func:`gather_through_boxes` reads every stencil point through its run's
box (the twin's arithmetic), and :func:`seam_scenes` makes inputs that
exercise the edge cases.  ``chip_smoke.py`` holds the kernel to its twin, to
the parent commit's kernel and its block paths to :func:`run_boxes` on these
scenes on the card; ``tests/test_torch_gather_box.py`` holds the twin on them
against the JAX package and the mirror's boxes to every stencil.  Every
input is made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody3d_tpu_torch.ops import mesh_cuda as mc

RUN = 256  # particles a run, a block's (mesh_gather.cu kThreads)
BOX_CAP = 2048  # cells of a run's box (mesh_gather.cu kBoxCap)


def seam_scenes(seed: int = 7) -> dict:
    """name: ``(pos_mass (n, 4) float32, n_real, sort)`` in the unit torus,
    positions in [0, 1); rows after ``n_real`` are padding (mass 0) at the
    origin.  ``sort``: Morton-sort the rows as periodic P3M does
    (:func:`scatter_checks.deposit_operands`).

    - corner: bodies within 0.03 of the torus' corner, so a Morton run
      holds cells on both sides of the seams in x, y and z at once;
    - far corner and padding: a uniform box with bodies a hair below 1 in
      each coordinate (their stencils wrap onto the first and the last
      cell) and 192 padding rows at the origin, which sort last, into the
      run of the far corner's cells;
    - spread: a uniform box in random order, so every run spans the box
      and its box exceeds the cap (the global path);
    - uniform: a uniform box in Morton order, whose runs take either path
      by their extent;
    - tight corner: bodies within 1.5e-3 of the torus' corner, so at the
      largest grid the wrapper takes (1,290: the second and third grids
      past 2^31 floats) runs across the seams are boxed, and on the
      isolated box (two clusters at the box's opposite corners) runs by
      the grid's far end are boxed too."""
    rng = np.random.default_rng(seed)
    n = 8192

    def rows(pos, real=n):
        pm_np = np.concatenate([pos, rng.uniform(1.0, 3.0, (pos.shape[0], 1))], 1).astype(np.float32)
        pm_np[real:] = 0.0
        pm_np[:, :3] = np.where(pm_np[:, :3] >= 1.0, 0.0, pm_np[:, :3])  # f32 rounding up to 1 wraps to 0
        return pm_np, real

    out = {"corner": (*rows(np.mod(rng.uniform(-0.03, 0.03, (n, 3)), 1.0)), True)}
    pos = rng.uniform(0.0, 1.0, (n, 3))
    far = 1.0 - rng.uniform(1e-7, 4e-3, (96, 3))
    pos[: far.shape[0]] = far
    pos[96:100] = [[1 - 1e-7, 1 - 1e-7, 1 - 1e-7], [1 - 1e-7, 0.0, 1 - 1e-7], [0.0, 1 - 1e-7, 0.5], [0.5, 0.5, 1 - 1e-7]]
    out["far corner and padding"] = (*rows(pos, n - 192), True)
    out["spread"] = (*rows(rng.uniform(0.0, 1.0, (n, 3))), False)
    out["uniform"] = (*rows(rng.uniform(0.0, 1.0, (n, 3)), n - 40), True)
    out["tight corner"] = (*rows(np.mod(rng.uniform(-1.5e-3, 1.5e-3, (n, 3)), 1.0)), True)
    return out


def run_boxes(c4: torch.Tensor, grid: int, order: int, periodic: bool, run_rows: int = RUN,
              cap: int = BOX_CAP) -> dict[str, torch.Tensor]:
    """The kernel's decisions for each run of ``run_rows`` rows of ``c4``:
    ``first (nb, 3)`` the box's first cell (unwrapped), ``extent (nb, 3)``,
    ``boxed (nb,)`` whether it takes the box (at most ``cap`` cells), and
    ``cells (n, 3)`` each row's base cell unwrapped about its run's first
    row (the base cell itself on the isolated box)."""
    n = c4.shape[0]
    nb = (n + run_rows - 1) // run_rows
    c = c4[:, :3].long()
    run = torch.arange(n, device=c.device) // run_rows
    cu = c
    if periodic:
        d = c - c[run * run_rows]
        cu = torch.where(d > grid // 2, c - grid, torch.where(d < -(grid // 2), c + grid, c))
    big = torch.iinfo(torch.int64).max
    least = torch.full((nb, 3), big, dtype=torch.int64, device=c.device).scatter_reduce(
        0, run[:, None].expand(-1, 3), cu, "amin")
    most = torch.full((nb, 3), -big, dtype=torch.int64, device=c.device).scatter_reduce(
        0, run[:, None].expand(-1, 3), cu, "amax")
    extent = most - least + order
    return {"first": least - (1 if order == 3 else 0), "extent": extent, "boxed": extent.prod(dim=1) <= cap,
            "cells": cu}


def block_paths(c4: torch.Tensor, grid: int, order: int, periodic: bool, sorted_rows: bool = True) -> list[int]:
    """The kernel's counts of blocks (runs) ``[box, global]`` (its
    ``block_paths``); not ``sorted_rows``: every block global."""
    if not sorted_rows:
        return [0, (c4.shape[0] + RUN - 1) // RUN]
    boxed = run_boxes(c4, grid, order, periodic)["boxed"]
    return [int(boxed.sum()), int((~boxed).sum())]


def gather_through_boxes(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int,
                         periodic: bool) -> torch.Tensor:
    """The twin's gather with every stencil point of a boxed run read through
    its run's box, as the kernel indexes it: the point's offset in the box
    from the unwrapped base cell, then the box cell's grid cell, wrapped mod
    ``grid`` on the periodic box.  Equal to ``mc.gather_plain`` bit for bit
    when the boxes are right (the same values, the same arithmetic)."""
    boxes = run_boxes(c4, grid, order, periodic)
    run = torch.arange(c4.shape[0], device=c4.device) // RUN
    first, extent, cu = boxes["first"][run], boxes["extent"][run], boxes["cells"]
    lo = 1 if order == 3 else 0
    offs = (-1, 0, 1) if order == 3 else (0, 1)
    boxed = boxes["boxed"][run]
    local = torch.stack([cu[:, a] - lo - first[:, a] for a in range(3)], 1)  # the stencil's first cell in the box
    w = mc.axis_weights(fm[:, :3], order)
    out = torch.zeros_like(fm)
    for a in range(order):
        for b in range(order):
            for d in range(order):
                box_at = local + torch.tensor([a, b, d], device=c4.device)
                if not bool(((box_at >= 0) & (box_at < extent))[boxed].all()):
                    raise AssertionError("a stencil point of a boxed run lies outside its run's box")
                cell = first + box_at
                if periodic:
                    cell = torch.remainder(cell, grid)
                direct = c4[:, :3].long() + torch.tensor([offs[a], offs[b], offs[d]], device=c4.device)
                if periodic:
                    direct = torch.remainder(direct, grid)
                cell = torch.where(boxed[:, None], cell, direct)
                idx = (cell[:, 0] * grid + cell[:, 1]) * grid + cell[:, 2]
                out[:, :3] += grids[:, idx].T * (w[a][:, 0] * w[b][:, 1] * w[d][:, 2])[:, None]
    return out
