"""The exact kernels' source split (``csrc/exact.cuh``): the split function
and the summation order it implies.

``force_exact`` and ``fused_step_exact`` sum each 128-source tile's terms
into their own partial in source order, each of S CTAs adds its range's
partials into a total, and the S totals are combined in rank order.  A
numpy model of that order (the pair arithmetic in f32, each fused
multiply-add rounded once) stays within the bound the kernel is held to on
the card, 1e-5 max-abs/scale, of the JAX package's Pallas kernel (interpret
mode) and of the port's f64 twin, with a 1e7 body among light ones, for
S = 1, 2 and 4."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.ops.pallas_force import accel_pallas, src_transposed  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops.launch import (  # noqa: E402
    EXACT_FILL, EXACT_MAX_SPLIT, EXACT_ROWS, EXACT_TILE, H100_SMS, exact_split, source_ranges,
)

G, EPS2 = 1e-4, 1e-4
TOL = 1e-5


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("n_tiles", [1, 2, 7, 8, 63, 314, 2049])
@pytest.mark.parametrize("split", [1, 2, 3, 5, 8])
def test_source_ranges_cover_every_tile_once_in_order(n_tiles, split):
    ranges = source_ranges(n_tiles, split)
    assert len(ranges) == split
    assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous, in rank order
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    assert [t for lo, hi in ranges for t in range(lo, hi)] == list(range(n_tiles))


@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_exact_split_is_one_where_the_row_blocks_fill_the_card(sms):
    for n_t in (256, 512, 1999, 8192, 40192, 65536, 131072, 262144, 2097152):
        for n_s in (n_t, 1999, 2097152):
            s = exact_split(n_t, n_s, sms)
            blocks, tiles = _ceil(n_t, EXACT_ROWS), _ceil(n_s, EXACT_TILE)
            cap = min(EXACT_MAX_SPLIT, tiles)
            assert 1 <= s <= cap
            if blocks >= EXACT_FILL * sms:
                assert s == 1
            else:  # the least S that fills the card, where the tiles and the cluster allow
                assert blocks * s >= EXACT_FILL * sms or s == cap
                assert s == 1 or blocks * (s - 1) < EXACT_FILL * sms
    assert exact_split(262144, 262144) == 1  # the sphere: 1,024 row blocks
    assert exact_split(40192, 40192) == 6  # two-galaxy: 157 row blocks, 942 CTAs


def _fma(a, b, c):
    """f32 a*b + c rounded once (the product is exact in f64; the f64 sum
    rounds first, which moves a rare result by an ulp)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def kernel_model(tgt: np.ndarray, src: np.ndarray, split: int) -> np.ndarray:
    """The exact kernels' sums for ``split`` CTAs a row block, in numpy f32."""
    tiles = _ceil(src.shape[0], EXACT_TILE)
    srcp = np.zeros((tiles * EXACT_TILE, 4), np.float32)
    srcp[: src.shape[0]] = src
    gm = np.float32(G) * srcp[:, 3]
    me = tgt[:, :3]
    totals = []
    for lo, hi in source_ranges(tiles, split):
        acc = np.zeros((tgt.shape[0], 3), np.float32)
        for c in range(lo, hi):
            part = np.zeros_like(acc)
            for j in range(c * EXACT_TILE, (c + 1) * EXACT_TILE):
                d = srcp[j, :3] - me
                d2 = _fma(d[:, 0], d[:, 0], _fma(d[:, 1], d[:, 1], _fma(d[:, 2], d[:, 2], np.float32(EPS2))))
                inv3 = (1.0 / np.sqrt((d2 * (d2 * d2)).astype(np.float64))).astype(np.float32)
                part = _fma((gm[j] * inv3)[:, None], d, part)
            acc = acc + part
        totals.append(acc)
    out = totals[0]
    for p in totals[1:]:
        out = out + p
    return np.concatenate([out, np.zeros((tgt.shape[0], 1), np.float32)], axis=1)


def heavy_scene(rng, n: int) -> np.ndarray:
    pm = np.concatenate(
        [rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    pm[n // 3, 3] = 1e7
    return pm


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("n_t,n_s", [(1024, 1024), (384, 1536)])
def test_summation_model_matches_pallas_and_twin(rng, split, n_t, n_s):
    src = heavy_scene(rng, n_s)
    tgt = src[-n_t:].copy()
    got = kernel_model(tgt, src, split)
    want = np.asarray(
        accel_pallas(
            jnp.asarray(tgt), src_transposed(jnp.asarray(src), G), eps2=EPS2,
            block_target=128, block_source=128, interpret=True,
        )
    )
    twin = cf.force_exact_plain(torch.from_numpy(tgt), torch.from_numpy(src), G, EPS2).numpy()
    scale = np.abs(twin).max()
    assert np.abs(got - want).max() / scale < TOL
    assert np.abs(got - twin).max() / scale < TOL
    assert (got[:, 3] == 0).all()
