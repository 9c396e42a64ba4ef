"""The short-range backward twin (what the ``short_range_bwd`` wrapper runs
on CPU tensors) on ``nbody3d_tpu_torch/pair_checks.py``'s planted scenes,
against the JAX package on the CPU, in both boundaries.

These are the scenes on which ``chip_smoke.py`` (9a, 13a) holds the kernel to
this twin and, with ``--parent``, to the parent commit's kernel bit for bit:
pairs one ulp either side of rcut² along one axis, a warp with one live lane,
masked slots, coincident rows, pairs across the periodic seams, and a warp
whose lanes lie on both sides of the periodic k''s switch from its series to
its closed form at u = 0.2.  Isolated: against ``_short_range_tiles_bwd_pallas``
(interpret mode) and ``jax.vjp`` of ``_short_range_tiles``, as
``tests/test_torch_p3m_grad.py`` runs them; periodic: against ``jax.grad`` of
``short_range_tiles(box=L)`` on the Pallas backend (interpret mode) and the
jnp form, as ``tests/test_torch_periodic_grad.py`` runs it.  Bounds: the JAX
tests' gradient bounds (``tests/test_p3m.py:397, 455``): x̄ and m̄ rtol 1e-4
with atol 1e-5 of the scale, σ̄ rel 1e-3."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
from nbody3d_tpu_torch import pair_checks  # noqa: E402
from nbody3d_tpu_torch.ops import p3m  # noqa: E402

ISOLATED = pair_checks.short_range_bwd_scenes(periodic=False)
PERIODIC = pair_checks.short_range_bwd_scenes(periodic=True)


def assert_close(got, want, rtol=1e-4, atol_scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max())


def twin(sc):
    """The wrapper on CPU tensors: ``(dps (N, 4), σ̄)`` as numpy."""
    dps, dsig = p3m.short_range_tiles_bwd(
        torch.from_numpy(sc["ps"]), torch.from_numpy(sc["g"]), torch.from_numpy(sc["nbr_idx"]), sc["eps2"],
        torch.tensor(sc["sigma"]), torch.tensor(sc["rcut"]), sc["block"], torch.from_numpy(sc["mask"]),
        box=sc["box"])
    return dps.numpy(), float(dsig)


def assert_agrees(got, got_sig, want, want_sig):
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert_close(got[:, :3], want[:, :3])
    assert_close(got[:, 3], want[:, 3])
    assert got_sig == pytest.approx(float(want_sig), rel=1e-3)


@pytest.mark.parametrize("name", list(ISOLATED))
def test_short_range_bwd_twin_on_planted_pairs(name):
    """Isolated: the twin against the Pallas backward (interpret) and
    ``jax.vjp`` of the jnp forward.  Tile 2's slots are all masked, so its
    rows get no cotangent from the pairs; rows 7 and 34 of tile 0 (partners
    one ulp inside rcut) do and rows 32 and 33 (at rcut, one ulp beyond)
    feel their tile-1 partners not at all."""
    sc = ISOLATED[name]
    ps, g, idx, mask, block = sc["ps"], sc["g"], sc["nbr_idx"], sc["mask"], sc["block"]
    nb = ps.shape[0] // block
    sigma, rcut = jnp.float32(sc["sigma"]), jnp.float32(sc["rcut"])
    jps, jidx, jmask = jnp.asarray(ps), jnp.asarray(idx), jnp.asarray(mask)
    pal, pal_sig = jp3m._short_range_tiles_bwd_pallas(jps, jnp.asarray(g[:, :3]), jidx, nb, sc["eps2"], sigma, rcut,
                                                      block, jmask, interpret=True)
    _, vjp = jax.vjp(lambda p, s: jp3m._short_range_tiles(p, jidx, 0, nb, sc["eps2"], s, rcut, block, nbr_mask=jmask),
                     jps, sigma)
    ad, ad_sig = vjp(jnp.asarray(g[:, :3]))
    got, got_sig = twin(sc)
    for want, want_sig in ((pal, pal_sig), (ad, ad_sig)):
        assert_agrees(got, got_sig, want, want_sig)
    assert not got[2 * block : 3 * block].any()  # tile 2: every slot masked
    # Tile 1 alone against tile 0: the pair terms of rows 7 and 34 and none of rows 32 and 33.
    one = np.zeros((nb, 1), np.int32)
    keep = np.zeros((nb, 1), np.float32)
    keep[1] = 1.0
    solo = dict(sc, nbr_idx=one, mask=keep)
    d1, _ = twin(solo)
    rows = d1[block : 2 * block]
    assert np.abs(rows[[7, 34]]).min(axis=1).min() > 0 and not rows[[32, 33]].any()


@pytest.mark.parametrize("name", list(PERIODIC))
def test_periodic_short_range_bwd_twin_on_planted_pairs(name):
    """Periodic: the twin against ``jax.grad`` of ``short_range_tiles(box)``
    on the Pallas backend (interpret mode) and the jnp form, for the loss
    sum(out · g).  On the k' switch scene the first warp's rows lie on
    both sides of u = 0.2 (rows 16 and 17 at the last f32 separation below
    it and the first above) and the second warp's all below."""
    sc = PERIODIC[name]
    ps, g, idx, mask, block, box = sc["ps"], sc["g"], sc["nbr_idx"], sc["mask"], sc["block"], sc["box"]
    nb = ps.shape[0] // block
    sigma, rcut = jnp.float32(sc["sigma"]), jnp.float32(sc["rcut"])
    jidx, jmask = jnp.asarray(idx), jnp.asarray(mask)

    def jloss(backend):
        def f(p, s):
            out = jp3m.short_range_tiles(p, jidx, 0, nb, sc["eps2"], s, rcut, block, nbr_mask=jmask, backend=backend,
                                         interpret=True, box=jnp.float32(box))
            return jnp.sum(out[:, :3] * jnp.asarray(g[:, :3]))
        return f

    got, got_sig = twin(sc)
    assert np.abs(got[:, :3]).max() > 0 and np.abs(got[:, 3]).max() > 0
    for backend in ("pallas", "jnp"):
        want, want_sig = jax.grad(jloss(backend), argnums=(0, 1))(jnp.asarray(ps), sigma)
        assert_agrees(got, got_sig, want, want_sig)
    if name.startswith("k'"):
        dx = ps[block : 2 * block, 0] - ps[:block, 0]
        a2 = np.float32(0.5) / (sc["sigma"] * sc["sigma"])
        series = (dx * dx) * a2 < np.float32(0.04)
        assert series[:17].all() and not series[17:32].any() and series[32:].all()
