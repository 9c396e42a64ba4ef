"""Planted-pair scenes for the pair kernels whose work depends on the data:
``short_range`` and ``short_range_bwd`` (which skip the pair arithmetic of
a warp's row slot when no lane of it is within rcut) and ``vjp_sym_hops``
(a heavy body among light ones).

``chip_smoke.py`` holds the kernels to their plain twins (and, with
``--parent``, ``short_range`` and ``short_range_bwd`` bit for bit to the
parent commit's kernels) on these scenes on the card;
``tests/test_torch_p3m.py``, ``tests/test_torch_periodic.py``,
``tests/test_torch_sr_bwd_planted.py`` and ``tests/test_torch_grad.py`` hold
the twins on the same scenes against the JAX package.  Every input is made
with numpy from a seed.

A short-range scene is a dict of ``ps (N, 4)`` f32 rows [x, y, z, m],
``g (N, 4)`` f32 the cotangent of the short range's output (N(0, 1), w
lane 0), ``nbr_idx (nb, k)`` int32 tile ids, ``mask (nb, k)`` f32, the f32
scalars ``sigma`` and ``rcut``, ``eps2``, ``block`` and ``box`` (``None``
for the isolated boundary); the lists are given, not selected, so a scene
can plant any pair in any slot.
"""

from __future__ import annotations

import numpy as np

BLOCK = 64  # rows a tile: one warp a row slot holds rows 0-31, the next 32-63
BOX = 4.0  # the periodic box of the scenes (rcut ~0.36 < BOX / 2)


def rcut_with_ulp_neighbours(start: float = 0.36) -> np.float32:
    """The first f32 ``r >= start`` whose neighbours square to the floats
    either side of ``r * r``: with ``rcut = r``, a pair at separation
    ``nextafter(r, 0)`` along one axis has ``r² = rcut² - 1 ulp`` (inside)
    and one at ``nextafter(r, inf)`` ``rcut² + 1 ulp`` (outside), in f32 and
    with or without a fused multiply-add (one axis: ``r² = fl(dx²)``)."""
    r = np.float32(start)
    while True:
        r = np.nextafter(r, np.float32(1))
        c = r * r
        lo, hi = np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(1))
        if lo * lo == np.nextafter(c, np.float32(0)) and hi * hi == np.nextafter(c, np.float32(1)):
            return r


def _scene(ps, nbr_idx, mask, rcut, box, eps2, seed: int = 0) -> dict:
    rcut = np.float32(rcut)
    g = np.random.default_rng(seed + 100).standard_normal((len(ps), 4)).astype(np.float32)
    g[:, 3] = 0.0
    return dict(ps=np.ascontiguousarray(ps, np.float32), g=g, nbr_idx=np.asarray(nbr_idx, np.int32),
                mask=np.asarray(mask, np.float32), sigma=np.float32(rcut / np.float32(4.5)), rcut=rcut,
                eps2=eps2, block=BLOCK, box=box)


def planted_rcut(box: float | None = None, seed: int = 0) -> dict:
    """Four tiles of 64 rows, four slots each.

    - Tile 0: targets at (0, y_i, z_i) on a 0.45 grid (farther apart than
      rcut, also through the seams of ``BOX``); tile 1 holds row i's
      partner at (dx_i, y_i, z_i), so each pair lies along x and the
      others are out of range.  Rows 0-31 (the first warp of a row slot):
      every partner at 0.5 but row 7's at ``nextafter(rcut, 0)``, a warp
      with exactly one live lane; row 32 at rcut (r² = rcut², outside),
      33 one ulp beyond, 34 one ulp inside, 35-63 at U(0.05, 0.5).
    - Tiles 2 and 3: random bodies in the box, tile 3 on tile 2's positions
      (coincident pairs, r² = 0), its last five rows zero (mass 0 at the
      origin, where tile 0's first target sits: coincident too).
    - Slots: tile 2's all masked; one slot masked in tiles 0 and 3.
    """
    rng = np.random.default_rng(seed)
    rcut = rcut_with_ulp_neighbours()
    n = 4 * BLOCK
    ps = np.zeros((n, 4), np.float32)
    i = np.arange(BLOCK)
    grid = np.stack([0.45 * (i % 8), 0.45 * (i // 8)], 1).astype(np.float32)
    ps[:BLOCK, 1:3] = grid
    dx = np.full(BLOCK, 0.5, np.float32)
    dx[7] = np.nextafter(rcut, np.float32(0))
    dx[32:35] = [rcut, np.nextafter(rcut, np.float32(1)), np.nextafter(rcut, np.float32(0))]
    dx[35:] = rng.uniform(0.05, 0.5, BLOCK - 35)
    ps[BLOCK : 2 * BLOCK, 0] = dx
    ps[BLOCK : 2 * BLOCK, 1:3] = grid
    ps[: 2 * BLOCK, 3] = rng.uniform(1.0, 3.0, 2 * BLOCK)
    span = BOX if box is not None else 2.0
    ps[2 * BLOCK : 3 * BLOCK, :3] = rng.uniform(0.0, span, (BLOCK, 3))
    ps[3 * BLOCK :, :3] = ps[2 * BLOCK : 3 * BLOCK, :3]
    ps[2 * BLOCK :, 3] = rng.uniform(1.0, 3.0, 2 * BLOCK)
    ps[n - 5 :] = 0.0
    nbr_idx = [[1, 0, 2, 3], [0, 1, 3, 2], [3, 2, 0, 1], [2, 3, 1, 0]]
    mask = np.ones((4, 4), np.float32)
    mask[0, 2] = mask[3, 2] = 0.0
    mask[2] = 0.0
    return _scene(ps, nbr_idx, mask, rcut, box, 1e-4 if box is None else 1e-6)


def planted_seam(seed: int = 0) -> dict:
    """The periodic box's seams: tile 0 within 0.15 of the origin corner,
    tile 1 within 0.15 of the far corner (every pair of the two tiles
    meets through one, two or three seams, the nearest within rcut), tile 2
    along the x = 0 face and tile 3 along x = ``BOX``; bodies exactly at 0
    and one float below ``BOX`` included, none nearer another than a few
    softening lengths (a pair much closer cancels 1/s³ - 1/r³ to nothing in
    f32, and the JAX kernel's A-S erfc swamps k there)."""
    rng = np.random.default_rng(seed)
    rcut = rcut_with_ulp_neighbours()
    top = np.float32(BOX)
    ps = np.zeros((4 * BLOCK, 4), np.float32)
    ps[:BLOCK, :3] = rng.uniform(0.0, 0.15, (BLOCK, 3))
    ps[BLOCK : 2 * BLOCK, :3] = top - rng.uniform(1e-3, 0.15, (BLOCK, 3)).astype(np.float32)
    ps[2 * BLOCK : 3 * BLOCK] = np.c_[rng.uniform(0.0, 0.1, BLOCK), rng.uniform(0.0, BOX, (BLOCK, 2)),
                                      np.zeros(BLOCK)]
    ps[3 * BLOCK :, 0] = top - rng.uniform(1e-3, 0.1, BLOCK).astype(np.float32)
    ps[3 * BLOCK :, 1:3] = ps[2 * BLOCK : 3 * BLOCK, 1:3] + rng.uniform(-0.1, 0.1, (BLOCK, 2))
    ps[:, :3] %= top
    below = np.nextafter(top, np.float32(0))
    ps[[0, BLOCK, 2 * BLOCK, 3 * BLOCK], :3] = [[0.0, 0.0, 0.0], [below, 0.03, 0.02], [0.0, 1.0, 2.0],
                                                [below, 1.02, 2.01]]
    ps[:, 3] = rng.uniform(1.0, 3.0, 4 * BLOCK)
    nbr_idx = [[0, 1, 2, 3], [1, 0, 3, 2], [2, 3, 0, 1], [3, 2, 1, 0]]
    return _scene(ps, nbr_idx, np.ones((4, 4), np.float32), rcut, BOX, 1e-6)


def short_range_scenes(periodic: bool) -> dict[str, dict]:
    """name: scene, for the isolated or the periodic ``short_range``."""
    if not periodic:
        return {"rcut² ± 1 ulp, one live lane, masked slots, coincident rows": planted_rcut()}
    return {"rcut² ± 1 ulp, one live lane, masked slots, coincident rows (box)": planted_rcut(BOX),
            "pairs across the seams": planted_seam()}


def planted_kp_switch(seed: int = 0) -> dict:
    """The periodic backward's switch of k' from its series to its closed
    form at u = r a = 0.2 (``csrc/short_range_bwd.cu``), within one row
    slot: tile 0's targets at x = 0 on a 0.45 grid in y and z (farther
    apart than rcut), tile 1's partners along x.  Rows 0-31 (one warp)
    straddle the switch: row i's partner at u = 0.1 + 0.2 i / 31, row 16's
    at the last f32 separation below the switch (r^2 a^2 < 0.04 in f32) and
    row 17's at the first one above; rows 32-63 all below it, u in [0.02,
    0.19].  Tiles 2 and 3: random bodies in the box (the closed form
    alone, and pairs past rcut).  Every slot live."""
    rng = np.random.default_rng(seed)
    rcut = rcut_with_ulp_neighbours()
    sigma = np.float32(rcut / np.float32(4.5))
    a2 = np.float32(0.5) / (sigma * sigma)  # the kernel's scal[3]; it switches where r^2 a^2 < 0.04
    r_switch = np.float32(0.2 * np.sqrt(2.0) * float(sigma))
    while (r_switch * r_switch) * a2 >= np.float32(0.04):
        r_switch = np.nextafter(r_switch, np.float32(0))
    while (r_switch * r_switch) * a2 < np.float32(0.04):
        r_switch = np.nextafter(r_switch, np.float32(1))
    ps = np.zeros((4 * BLOCK, 4), np.float32)
    i = np.arange(BLOCK)
    grid = np.stack([0.45 * (i % 8), 0.45 * (i // 8)], 1).astype(np.float32)
    ps[:BLOCK, 1:3] = grid
    u = np.concatenate([0.1 + 0.2 * np.arange(32) / 31, rng.uniform(0.02, 0.19, BLOCK - 32)])
    dx = (u / 0.2 * r_switch).astype(np.float32)
    dx[16], dx[17] = np.nextafter(r_switch, np.float32(0)), r_switch  # the last below, the first at or above
    ps[BLOCK : 2 * BLOCK, 0] = dx
    ps[BLOCK : 2 * BLOCK, 1:3] = grid
    ps[2 * BLOCK :, :3] = rng.uniform(0.0, BOX, (2 * BLOCK, 3))
    ps[:, 3] = rng.uniform(1.0, 3.0, 4 * BLOCK)
    nbr_idx = [[1, 0, 2, 3], [0, 1, 3, 2], [3, 2, 0, 1], [2, 3, 1, 0]]
    return _scene(ps, nbr_idx, np.ones((4, 4), np.float32), rcut, BOX, 1e-6, seed)


def mutual(mask: np.ndarray, nbr_idx: np.ndarray) -> np.ndarray:
    """``mask`` with every slot (t, j) killed whose tile j does not list t
    under its own mask: the mutual mask that the port's selection makes
    (``ops/p3m.py::mutual_neighbor_mask``), under which the backward's
    gather over each row's own list is the exact VJP."""
    out = mask.copy()
    for t, j in zip(*np.nonzero(mask)):
        if not ((nbr_idx[nbr_idx[t, j]] == t) & (mask[nbr_idx[t, j]] != 0)).any():
            out[t, j] = 0.0
    return out


def short_range_bwd_scenes(periodic: bool) -> dict[str, dict]:
    """name: scene, for the isolated or the periodic ``short_range_bwd``:
    the forward's scenes under :func:`mutual` masks and, periodic,
    :func:`planted_kp_switch`."""
    scenes = {name: dict(sc, mask=mutual(sc["mask"], sc["nbr_idx"])) for name, sc in short_range_scenes(periodic).items()}
    if periodic:
        scenes["k' series / closed form switch in one warp (box)"] = planted_kp_switch()
    return scenes


def vjp_heavy(n: int = 1024, b: int = 256, n_real: int = 1000, seed: int = 0):
    """``(pm (n, 4), abar (n, 4))`` f32 for the force VJP at tile ``b``:
    bodies N(0, 1) with masses U(10, 50), one of 1e7 in tile 1 (its row
    sums hold terms 1e5x the rest), rows from ``n_real`` on zero (mass and
    cotangent), the cotangent N(0, 1) with its w lane 0."""
    rng = np.random.default_rng(seed)
    pm = np.concatenate([rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)
    pm[b + 17, 3] = 1e7
    abar = rng.standard_normal((n, 4)).astype(np.float32)
    abar[:, 3] = 0.0
    pm[n_real:] = 0.0
    abar[n_real:] = 0.0
    return pm, abar
