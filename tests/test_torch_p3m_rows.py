"""The P3M pieces the sharded step calls on one rank's tiles, against the
JAX package: the neighbour selection of a range of target rows (flat and
two-level, isolated and periodic) bit for bit against the JAX
``_select_neighbors(lo_b, hi_b, row0, nrows, ...)`` compiled, and equal to
those rows of the all-rows selection; ``short_range_tiles`` with ``nt``
target tiles over more source rows against the JAX
``short_range_tiles(ps, nbr, 0, nt, ...)`` (jnp; the bound of
``tests/test_torch_p3m.py``: rtol 2e-4, atol 3e-6 of the max) and equal to
those rows of the all-targets call; the slot flags of the targets' rows.

The scene is ``tests/test_p3m.py``'s two-galaxy preset at n = 4,096,
padded to 8,192 rows."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
import nbody3d_tpu.ops.pm as jpm  # noqa: E402
from nbody3d_tpu.models.registry import make_preset  # noqa: E402
from nbody3d_tpu.ops.ewald import wrap_box as jax_wrap_box  # noqa: E402
from nbody3d_tpu.ops.morton import morton_keys as jax_morton_keys  # noqa: E402
from nbody3d_tpu_torch.ops import p3m  # noqa: E402

G, EPS2, GRID = 1e-4, 1e-4, 32
BOX = 16.0


@pytest.fixture(scope="module")
def scene():
    pos_mass, _, _ = make_preset("two-galaxy", seed=0, G=G, n=4096)
    n_real = pos_mass.shape[0]
    return np.pad(pos_mass, ((0, 8192 - n_real), (0, 0))).astype(np.float32), n_real


def tiles(pm_np, n_real, block, periodic):
    """Both packages' sorted rows, tile AABBs and ``h`` (the periodic box:
    wrapped rows, ``h = L/grid``)."""
    jx = jnp.asarray(pm_np)
    if periodic:
        jx = jnp.concatenate([jax_wrap_box(jx[:, :3], jnp.float32(BOX)), jx[:, 3:]], axis=1)
        h = jnp.float32(BOX) / GRID
    else:
        _, h = jpm._box(jx[:n_real, :3], GRID)
    jps = jx[jnp.argsort(jax_morton_keys(jx, n_real), stable=True)]
    lo_b, hi_b = jp3m._sorted_aabbs(jps, n_real, block)
    tps = torch.from_numpy(np.asarray(jps).copy())
    tlo, thi = p3m._sorted_aabbs(tps, n_real, block)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo_b))
    return (jps, lo_b, hi_b, h), (tps, tlo, thi, torch.tensor(np.asarray(h)))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize(
    "block,flat_max,ranges",
    [
        (64, None, [(0, 32), (32, 32), (96, 32)]),  # 128 tiles, flat: four ranks' rows
        (256, None, [(0, 8), (8, 24)]),  # 32 tiles, uneven ranges
        (32, 4, [(0, 64), (64, 64), (192, 64)]),  # 256 tiles, two-level (supers of 32)
        (64, 4, [(0, 24), (24, 24), (48, 24)]),  # 128 tiles, rows of 24: supers of 8
    ],
)
def test_row_range_selection_matches_jax(scene, monkeypatch, periodic, block, flat_max, ranges):
    pm_np, n_real = scene
    (_, lo_b, hi_b, h), (_, tlo, thi, th) = tiles(pm_np, n_real, block, periodic)
    if flat_max is not None:
        monkeypatch.setattr(p3m, "_FLAT_MAX_TILES", flat_max)
        monkeypatch.setattr(jp3m, "_FLAT_MAX_TILES", flat_max)
    L = BOX if periodic else None
    tL = torch.tensor(BOX) if periodic else None
    full = p3m._select_neighbors(tlo, thi, th, 16, L=tL)
    for row0, nrows in ranges:
        got = p3m._select_neighbors(tlo, thi, th, 16, L=tL, row0=row0, nrows=nrows)
        want = jax.jit(lambda a, b, c, d, r0=row0, nr=nrows: jp3m._select_neighbors(a, b, r0, nr, c, 16, L=d))(
            lo_b, hi_b, h, None if L is None else jnp.float32(L))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if flat_max is None or nrows % 32 == 0:
            # The same supers as the all-rows selection: its rows, bit for bit.
            for g, f in zip(got, full):
                np.testing.assert_array_equal(g.numpy(), f[row0 : row0 + nrows].numpy())


def test_row_range_hier_needs_whole_supers(scene, monkeypatch):
    pm_np, n_real = scene
    _, (_, tlo, thi, th) = tiles(pm_np, n_real, 64, False)
    with pytest.raises(ValueError, match="super-tile"):
        p3m._select_neighbors_hier(tlo, thi, th, 16, row0=4, nrows=32)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("block,nt", [(128, 16), (256, 5)])
def test_short_range_target_tiles_match_jax(scene, periodic, block, nt):
    """``nt`` target tiles (the front of ``ps``) against sources anywhere in
    it, as the sharded step's ``[slice ; halo]`` call runs."""
    pm_np, n_real = scene
    (jps, lo_b, hi_b, h), (tps, tlo, thi, th) = tiles(pm_np, n_real, block, periodic)
    L = jnp.float32(BOX) if periodic else None
    kth, neg, idx = jax.jit(lambda a, b, c, d: jp3m._select_neighbors(a, b, 0, nt, c, 8, L=d))(lo_b, hi_b, h, L)
    kth_all = jax.jit(lambda a, b, c, d: jp3m._select_neighbors(a, b, 0, lo_b.shape[0], c, 8, L=d))(
        lo_b, hi_b, h, L)[0]
    mask = jp3m.mutual_neighbor_mask(neg, idx, kth_all)
    sigma, rcut = 1.5 * h, 4.5 * 1.5 * h
    want = np.asarray(jp3m.short_range_tiles(jps, idx, 0, nt, EPS2, sigma, rcut, block, nbr_mask=mask,
                                             backend="jnp", box=L))
    tsig, trcut = 1.5 * th, 4.5 * 1.5 * th
    tidx, tmask = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(mask))
    box = BOX if periodic else None
    got = p3m.short_range_tiles(tps, tidx, EPS2, tsig, trcut, block, tmask, box=box, nt=nt).numpy()
    assert got.shape == (nt * block, 4) and not got[:, 3].any()
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=2e-4, atol=3e-6 * np.abs(want).max())
    # The same rows of the all-targets call (the other rows' lists zeroed).
    nb = tps.shape[0] // block
    pad_idx = torch.zeros((nb, 8), dtype=tidx.dtype)
    pad_mask = torch.zeros((nb, 8))
    pad_idx[:nt], pad_mask[:nt] = tidx, tmask
    full = p3m.short_range_tiles(tps, pad_idx, EPS2, tsig, trcut, block, pad_mask, box=box).numpy()
    np.testing.assert_array_equal(got, full[: nt * block])


def test_dense_slots_of_target_tiles(scene):
    """The slot flags of ``nt`` target tiles are those rows of the flags of
    every tile."""
    pm_np, n_real = scene
    _, (tps, tlo, thi, th) = tiles(pm_np, n_real, 128, False)
    _, _, idx = p3m._select_neighbors(tlo, thi, th, 8)
    rcut = 4.5 * 1.5 * th
    part = p3m._dense_slots(tps, idx[:16], 128, rcut)
    np.testing.assert_array_equal(part.numpy(), p3m._dense_slots(tps, idx, 128, rcut)[:16].numpy())


def test_short_range_checks_the_target_count():
    ps = torch.zeros((512, 4))
    one = torch.tensor(1.0)
    ids, mask = torch.zeros((3, 2), dtype=torch.int64), torch.ones((3, 2))
    with pytest.raises(ValueError, match="3 target tiles"):
        p3m.short_range_tiles(ps, ids, EPS2, one, one, 256, mask, nt=3)  # 3 tiles of 256 > 512 rows
    with pytest.raises(ValueError, match="2 target tiles"):
        p3m.short_range_tiles(ps, ids, EPS2, one, one, 128, mask, nt=2)  # 3 rows of lists for 2 targets
    assert p3m.short_range_tiles(ps, ids, EPS2, one, one, 128, mask, nt=3).shape == (384, 4)
