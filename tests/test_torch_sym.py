"""The fused Newton-3 step: the port's plain sym stages, chained
(diag_prep -> hops -> epilogue, what the wrappers run on CPU tensors),
against the JAX package's fused step and sym force in interpret mode.

Bounds are the JAX package's own (``tests/test_sym.py``): accel
max-abs/scale < 5e-5 against the fused step and < 2e-5 against the sym
force, p and v within 1e-6, padded rows frozen with zero accel.  Both
sides are f32 with different summation orders."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.ops.force_jnp import accel_direct as jax_accel_direct  # noqa: E402
from nbody3d_tpu.ops.pallas_force import accel_sym_pallas, sym_verlet_step_pallas  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, split_hops  # noqa: E402

G, EPS2, DT = 1e-4, 1e-4, 1e-3

# (n_pad, tile, n_real): nt = 2, 3 (odd), 4 (even), padded and unpadded.
CASES = [(256, 128, 256), (256, 128, 200), (384, 128, 384), (384, 128, 300),
         (512, 128, 512), (512, 128, 500), (640, 128, 600)]


def inputs(rng, n, n_real, heavy=False):
    pm = np.concatenate(
        [rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    if heavy:
        pm[0, 3] = 1e7
    pm[n_real:, 3] = 0.0
    vel = np.concatenate([rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1).astype(np.float32)
    aold = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], axis=1).astype(np.float32)
    return pm, vel, aold


def sym_accel(pm, b):
    src, acc_d = cf.sym_diag_prep(torch.from_numpy(pm), G, EPS2, b)
    return (acc_d + cf.sym_hops(src, EPS2, b)).numpy()


@pytest.mark.parametrize("n,b,n_real", CASES)
def test_sym_step_matches_jax_fused_step(rng, n, b, n_real):
    pm, vel, aold = inputs(rng, n, n_real)
    p, v, a = (torch.from_numpy(x.copy()) for x in (pm, vel, aold))
    cf.sym_step_(p, v, a, DT, G, eps2=EPS2, b=b, n_real=n_real)
    p0, v0, a0 = (
        np.asarray(x)
        for x in sym_verlet_step_pallas(
            jnp.asarray(pm), jnp.asarray(vel), jnp.asarray(aold), jnp.float32(DT), G,
            eps2=EPS2, block=b, n_real=(None if n_real >= n else n_real), interpret=True,
        )
    )
    p, v, a = p.numpy(), v.numpy(), a.numpy()
    assert np.abs(a - a0).max() / np.abs(a0).max() < 5e-5
    np.testing.assert_allclose(p, p0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v0, rtol=0, atol=1e-6)
    if n_real < n:
        np.testing.assert_array_equal(p[n_real:], pm[n_real:])
        np.testing.assert_array_equal(v[n_real:], vel[n_real:])
        np.testing.assert_array_equal(a[n_real:], 0.0)
    np.testing.assert_array_equal(p[:, 3], pm[:, 3])  # masses ride along


@pytest.mark.parametrize("n,b", [(256, 128), (384, 128), (512, 128), (512, 256)])
def test_sym_accel_matches_jax_sym_force(rng, n, b):
    pm, _, _ = inputs(rng, n, n, heavy=True)
    got = sym_accel(pm, b)
    want = np.asarray(accel_sym_pallas(jnp.asarray(pm), G, eps2=EPS2, block=b, interpret=True))
    oracle = np.asarray(jax_accel_direct(jnp.asarray(pm), G, eps2=EPS2))
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-5
    assert np.abs(got - oracle).max() / np.abs(oracle).max() < 2e-5


@pytest.mark.parametrize("n,b", [(384, 128), (512, 128)])
def test_sym_momentum_conserved(rng, n, b):
    """Newton-3: sum m*a vanishes to f32 reduction order (each pair's two
    terms share inv3 and dx)."""
    pm, _, _ = inputs(rng, n, n, heavy=True)
    a = sym_accel(pm, b).astype(np.float64)
    m = pm[:, 3:4].astype(np.float64)
    net = np.abs((m * a[:, :3]).sum(axis=0)).max()
    scale = np.abs(m * a[:, :3]).sum()
    assert net / scale < 1e-6


@pytest.mark.parametrize("nt", [2, 3, 4, 5, 8])
def test_hop_pair_sets_cover_each_pair_once(nt):
    seen = {}
    for k0, nk, grid_i in split_hops(nt):
        for i in range(grid_i):
            for k in range(k0, k0 + nk):
                pair = frozenset((i, (i + k) % nt))
                seen[pair] = seen.get(pair, 0) + 1
    assert len(seen) == nt * (nt - 1) // 2
    assert set(seen.values()) == {1}


def test_epilogue_plain_order_matches_integrator(rng):
    """The epilogue is Verlet on acc_diag + acc_hop, bit for bit."""
    from nbody3d_tpu_torch.ops.integrate import apply_integrator, valid_mask

    n, n_real = 256, 250
    pm, vel, aold = (torch.from_numpy(x) for x in inputs(rng, n, n_real))
    acc_d, acc_h = torch.randn(n, 4), torch.randn(n, 4)
    acc_d[:, 3] = acc_h[:, 3] = 0.0
    p, v, a = pm.clone(), vel.clone(), aold.clone()
    cf.sym_epilogue_(acc_d, acc_h, p, v, a, DT, n_real)
    want = apply_integrator("verlet", pm, vel, aold, acc_d + acc_h, DT, valid_mask(n, n_real, "cpu"))
    for got, w in zip((p, v, a), want):
        assert torch.equal(got, w)


def test_sym_wrappers_refuse_bad_input(rng):
    pm = torch.from_numpy(inputs(rng, 256, 256)[0])
    with pytest.raises(ValueError, match="must divide"):
        cf.sym_diag_prep(pm, G, EPS2, 2048)
    with pytest.raises(ValueError):
        cf.sym_hops(pm, EPS2, 100)
    with pytest.raises(RuntimeError, match="never take such tensors"):
        cf.sym_diag_prep(pm.clone().requires_grad_(), G, EPS2, 128)
    with pytest.raises(ValueError, match="one shape"):
        cf.sym_epilogue_(pm, pm, pm, pm, pm[:128].clone(), DT, 256)
    assert all(c == 0 for c in launch_counts().values())
