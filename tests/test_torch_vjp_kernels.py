"""The force VJP kernels' summation orders, modelled on the CPU.

``csrc/vjp_full.cu`` sums each 128-source tile's pair terms into a partial
in source order (the self pair skipped), each of S CTAs adds its range's
partials into a total, and the S totals are combined in rank order
(``exact::finish``).  A torch model of that order (the pair terms of
``force_vjp._pair_terms`` in f32) stays within the bound the kernel is held
to on the card, 1e-5 of each quantity's scale (Ḡ's: the sum of its terms'
magnitudes), of the JAX package's Pallas VJP (interpret mode) and of the
port's f64-summed twin, with a 1e7 body among light ones and padded rows,
for S = 1, 2 and 4.

``csrc/vjp_sym_diag.cu``'s Newton-3 loop at tile 256 takes each unordered
pair of a tile once and hands the source's terms down the warp by shuffles
to per-warp slabs.  A numpy model of its indices (steps, shuffles, slab
rows, the final gather) on integer terms gives every row each of its 255
ordered pairs' terms exactly once."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.ops.force_vjp import force_vjp_pallas  # noqa: E402
from nbody3d_tpu_torch.ops import force_vjp as fv  # noqa: E402
from nbody3d_tpu_torch.ops.launch import EXACT_TILE, source_ranges  # noqa: E402

G, EPS2 = 1e-4, 1e-4
TOL = 1e-5


def vjp_full_model(pm: torch.Tensor, abar: torch.Tensor, split: int):
    """``vjp_full``'s sums for ``split`` CTAs a row block: ``(pm_bar, Ḡ)``."""
    n = pm.shape[0]
    tiles = -(-n // EXACT_TILE)
    xk, ak = pm[:, None], abar[:, None, :3]
    totals = []
    for lo, hi in source_ranges(tiles, split):
        acc = torch.zeros((n, 5))
        for c in range(lo, hi):
            part = torch.zeros((n, 5))
            for j in range(c * EXACT_TILE, min((c + 1) * EXACT_TILE, n)):
                t, mbar_t, _, phi_t, _ = fv._pair_terms(xk, ak, pm[None, j : j + 1], abar[None, j : j + 1, :3], EPS2)
                term = torch.cat([t[:, 0], mbar_t, phi_t], dim=1)
                term[j] = 0.0  # the self pair
                part = part + term
            acc = acc + part
        totals.append(acc)
    out = totals[0]
    for p in totals[1:]:
        out = out + p
    return out[:, :4] * G, out[:, 4].double().sum()


def heavy_scene(rng, n: int, n_real: int):
    pm = np.concatenate([rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)
    pm[n // 3, 3] = 1e7
    abar = np.concatenate([rng.standard_normal((n, 3)), np.zeros((n, 1))], axis=1).astype(np.float32)
    pm[n_real:] = 0.0
    abar[n_real:] = 0.0
    return torch.from_numpy(pm), torch.from_numpy(abar)


def gbar_scale(pm: torch.Tensor, abar: torch.Tensor) -> float:
    """sum_k |A_k . F_k| in f64, F per unit G: the scale of Ḡ's terms."""
    x, m = pm[:, :3].double(), pm[:, 3].double()
    d = x[None] - x[:, None]
    w = (torch.sum(d * d, dim=-1) + EPS2) ** -1.5
    return float(torch.sum(abar[:, :3].double() * torch.einsum("kj,j,kjc->kc", w, m, d), dim=1).abs().sum())


@pytest.mark.parametrize("split", [1, 2, 4])
def test_vjp_full_summation_model_matches_pallas_and_twin(rng, split):
    pm, abar = heavy_scene(rng, 384, 379)
    got, g_got = vjp_full_model(pm, abar, split)
    twin, g_twin = fv.vjp_full_plain(pm, G, abar, EPS2)
    pal, g_pal = force_vjp_pallas(jnp.asarray(pm.numpy()), G, jnp.asarray(abar.numpy()), eps2=EPS2, block=128,
                                  interpret=True)
    pal = torch.from_numpy(np.array(pal))
    scale = gbar_scale(pm, abar)
    for want, g_want in ((twin, float(g_twin)), (pal, float(g_pal))):
        for cols in (slice(0, 3), slice(3, 4)):
            assert float((got[:, cols] - want[:, cols]).abs().max() / want[:, cols].abs().max()) < TOL
        assert abs(float(g_got) - g_want) / scale < TOL
    assert (got[379:, :3] == 0).all()


def n3_model(m: np.ndarray) -> np.ndarray:
    """Row sums of ``vjp_sym_diag``'s Newton-3 loop at tile 256 where the
    pair (target i, source j) gives the target m[i, j] and the source m[j, i]
    (as the VJP pair gives t and -t): the kernel's steps, shuffles and slab
    rows, lane by lane."""
    b, warps, span = 256, 8, 160
    out, slab = np.zeros(b), np.zeros((warps, span))
    lanes = np.arange(32)
    for w in range(warps):
        t = 32 * w + lanes
        steps = b // 2 if 32 * w < b // 2 else b // 2 - 1
        own, rev = np.zeros(32), np.zeros(32)
        for r in range(1, steps + 1):
            s = (t + r) % b
            own += m[t, s]
            rev += m[s, t]
            if r < steps:
                slab[w, r - 1] = rev[0]  # lane 0 hands row t0 + r over
                rev = np.append(rev[1:], 0.0)  # __shfl_down_sync by 1; lane 31 starts anew
        slab[w, lanes + steps - 1] = rev
        out[t] += own
    for t in range(b):
        for v in range(warps):
            o = (t - 32 * v - 1) & (b - 1)
            if o < span:
                out[t] += slab[v, o]
    return out


def test_n3_schedule_gives_every_row_each_pair_once(rng):
    m = rng.integers(1, 1 << 20, size=(256, 256)).astype(np.float64)  # exact sums in f64
    np.fill_diagonal(m, 1 << 40)  # a self pair taken anywhere would show
    want = m.sum(axis=1) - np.diag(m)
    np.testing.assert_array_equal(n3_model(m), want)
