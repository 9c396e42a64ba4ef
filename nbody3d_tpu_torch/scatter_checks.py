"""The two scatter kernels' adversarial inputs, and the bound that holds a
deposit summed in f32 in any order.

``chip_smoke.py`` holds ``splat_resolve`` and ``mesh_deposit`` to their
plain twins on these inputs on the card (frames word for word, deposits
within :func:`f32_sum_bounds`); ``tests/test_torch_render.py``,
``tests/test_torch_mesh.py`` and ``tests/test_torch_periodic.py`` hold the
twins on the same inputs against the JAX package.  Every input is made
with numpy from a seed.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody3d_tpu_torch.ops import mesh_cuda as mc
from nbody3d_tpu_torch.ops import p3m, pm


def resolve_adversarial(seed: int = 5) -> dict:
    """name: ``(cx, cy, depth_bits, rgb24, r, visible, width, height)``,
    numpy arrays of ``splat_resolve``'s dtypes.

    - a pile-up: 4,096 splats centred on one pixel (radii U(0.5, 3.5), four
      depths, so keys tie on depth and colour decides), then 256 around it;
    - r = 64 discs (and the floats either side of 64) centred on the
      frame's four corners and off the frame, partly and wholly outside
      (one 90.5 px from the nearest corner covers nothing), over 2,000
      splats of r U(0.5, 8)."""
    rng = np.random.default_rng(seed)

    def keys(n, depths=None):
        d = rng.choice(depths, n) if depths is not None else rng.uniform(0.0, 1.0, n)
        return (d.astype(np.float32).view(np.int32), rng.integers(0, 1 << 24, n).astype(np.int32))

    w, h = 96, 80
    cx = np.concatenate([np.full(4096, 37), rng.integers(30, 45, 256)]).astype(np.int32)
    cy = np.concatenate([np.full(4096, 23), rng.integers(16, 31, 256)]).astype(np.int32)
    n = cx.shape[0]
    depth, rgb = keys(n, np.array([0.25, 0.5, 0.5000001, 0.75]))
    r = rng.uniform(0.5, 3.5, n).astype(np.float32)
    r[:4] = [0.5, 1.0, 2.0, 3.0]
    out = {"pile-up 4,096 on one pixel, 96x80": (cx, cy, depth, rgb, r, rng.random(n) < 0.9, w, h)}

    w, h = 200, 150
    big = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (-40, 75), (w + 63, 20), (100, -64), (100, h + 63),
           (-64, -64), (w + 64, h + 64), (100, 75)]
    radii = np.array([64.0, np.nextafter(np.float32(64), np.float32(0)), np.nextafter(np.float32(64), np.float32(99))],
                     np.float32)
    bx = np.array([p[0] for p in big] * 3, np.int32)
    by = np.array([p[1] for p in big] * 3, np.int32)
    br = np.repeat(radii, len(big))
    m = 2000
    cx = np.concatenate([bx, rng.integers(-8, w + 8, m)]).astype(np.int32)
    cy = np.concatenate([by, rng.integers(-8, h + 8, m)]).astype(np.int32)
    r = np.concatenate([br, rng.uniform(0.5, 8.0, m)]).astype(np.float32)
    depth, rgb = keys(cx.shape[0])
    out["r = 64 at the corners and off the frame, 200x150"] = (cx, cy, depth, rgb, r, np.ones(cx.shape[0], bool), w, h)
    return out


def deposit_adversarial(seed: int = 6) -> dict:
    """name: ``(pos_mass (n, 4) float32, n_real, periodic)``, bodies made
    with numpy for the isolated and the periodic deposit.  Isolated: the box is the real bodies'; periodic:
    the unit box, positions in [0, 1).  Rows after ``n_real`` are padding
    (mass 0).  :func:`deposit_operands` Morton-sorts every scene but the
    shuffled one, as P3M hands the deposit its rows.

    - one cell: all bodies but two box-setting corners within 1e-4 of one
      point (on the torus, of one point near the far corner);
    - shuffled: two dense blobs and a uniform background in random order,
      so a block's run spans the grid;
    - octant crossing: uniform bodies, Morton-sorted, whose runs of 256
      consecutive rows straddle the boundaries of the top octants;
    - seam: bodies in a cube of side 0.1 about the torus' corner, so a
      Morton run holds cells on both sides of a seam."""
    rng = np.random.default_rng(seed)
    n = 8192
    out = {}

    def rows(pos, real=n, mass=None):
        m = rng.uniform(1.0, 3.0, pos.shape[0]) if mass is None else mass
        pm_np = np.concatenate([pos, m[:, None]], 1).astype(np.float32)
        pm_np[real:] = 0.0
        return pm_np, real

    pos = 0.013 + rng.uniform(-1e-4, 1e-4, (n, 3)) + [0.0, 0.008, -0.03]
    pos[:2] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    out["one cell"] = (*rows(pos), False)
    blobs = rng.choice(3, n, p=[0.4, 0.4, 0.2])
    pos = np.where(blobs[:, None] == 2, rng.uniform(-1, 1, (n, 3)),
                   rng.normal(0.0, 0.05, (n, 3)) + np.where(blobs[:, None] == 0, -0.5, 0.5))
    out["shuffled"] = (*rows(pos), False)
    out["octant crossing"] = (*rows(rng.uniform(-1, 1, (n, 3)), n - 37), False)
    out["one cell, periodic"] = (*rows(0.98 + rng.uniform(-1e-5, 1e-5, (n, 3))), True)
    out["seam, periodic"] = (*rows(np.mod(rng.uniform(-0.05, 0.05, (n, 3)), 1.0)), True)
    out["octant crossing, periodic"] = (*rows(rng.uniform(0, 1, (n, 3)), n - 192), True)
    return out


def deposit_operands(pm_np: np.ndarray, n_real: int, periodic: bool, grid: int, order: int, dev, sort: bool = True):
    """The kernels' operands ``(c4, fm)`` of a :func:`deposit_adversarial`
    scene on ``dev``: the rows Morton-sorted (``sort``), the cells of
    ``p3m._tsc_cells`` (order 3) or ``pm._cic_cells`` (2) in the real
    bodies' box or the unit torus."""
    rows = torch.from_numpy(pm_np).to(dev)
    if sort:
        rows = rows[torch.argsort(p3m.morton_keys(rows, n_real), stable=True)].contiguous()
    cells = p3m._tsc_cells if order == 3 else pm._cic_cells
    if periodic:
        c, f = cells(rows[:, :3], torch.zeros(3, device=dev), torch.tensor(1.0 / grid, device=dev), grid,
                     periodic=True)
    else:
        c, f = cells(rows[:, :3], *pm._box(rows[:n_real, :3], grid), grid)
    return mc.mesh_operands(c, f, rows[:, 3])


def f32_sum_bounds(c4, fm, grid: int, order: int, periodic: bool = False, term_ulps: int = 0):
    """The deposit's f32 terms (the twin's products) summed in f64:
    ``(idx, val, rho64, allowed)``, ``allowed`` each cell's bound of f32
    summation in any order, (adds into the cell + ``term_ulps``) x 2^-24 x
    the cell's sum (every term is >= 0); ``term_ulps`` covers terms that
    another code rounds in its own order (the JAX package's)."""
    idx, val = zip(*mc._stencil(c4, fm[:, :3], grid, order, mass=fm[:, 3], periodic=periodic))
    idx, val = torch.cat(idx), torch.cat(val)
    rho64 = torch.zeros(grid**3, dtype=torch.float64, device=fm.device).index_add_(0, idx, val.double())
    adds = torch.bincount(idx, minlength=grid**3).double()
    return idx, val, rho64, (adds + term_ulps * (adds > 0)) * 2.0**-24 * rho64


def f32_sum_excess(rho: torch.Tensor, rho64: torch.Tensor, allowed: torch.Tensor) -> tuple[float, float]:
    """``(worst cell error / its bound, total error / the summed bounds)`` of
    a deposit against :func:`f32_sum_bounds`' f64 sums."""
    err = (rho.reshape(-1).double() - rho64).abs()
    total = abs(float(rho.double().sum()) - float(rho64.sum())) / float(allowed.sum())
    return float((err / allowed.clamp(min=1e-300)).max()), total
