"""The exact force: the port's plain twin of ``force_exact`` (what the
wrapper runs on CPU tensors) and its oracle, against the JAX package's
Pallas kernel in interpret mode and its jnp oracle.

Tolerance ``rtol=1e-5, atol=1e-7`` is the JAX package's own for its
kernel against its oracle (``tests/test_pallas.py``): both sides are f32
with sums taken in different orders."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.ops.force_jnp import accel_direct as jax_accel_direct  # noqa: E402
from nbody3d_tpu.ops.force_jnp import accel_partial as jax_accel_partial  # noqa: E402
from nbody3d_tpu.ops.pallas_force import accel_pallas, src_transposed  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.force_torch import accel_direct, accel_partial  # noqa: E402

G, EPS2 = 1e-4, 1e-4
TOL = dict(rtol=1e-5, atol=1e-7)


def bodies(rng, n, n_real):
    pm = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    pm[n_real:] = 0.0  # padded tail: zero mass at the origin
    return pm


@pytest.mark.parametrize("n,n_real", [(512, 512), (512, 460), (384, 300)])
def test_force_exact_plain_matches_pallas_and_oracle(rng, n, n_real):
    pm = bodies(rng, n, n_real)
    t = torch.from_numpy(pm)
    got = cf.force_exact(t, t, G, EPS2).numpy()
    kern = np.asarray(
        accel_pallas(
            jnp.asarray(pm), src_transposed(jnp.asarray(pm), G), eps2=EPS2,
            block_target=128, block_source=128, interpret=True,
        )
    )
    oracle = np.asarray(jax_accel_direct(jnp.asarray(pm), G, eps2=EPS2))
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    assert (got[:, 3] == 0).all()


def test_force_exact_rectangular_targets(rng):
    pm = bodies(rng, 256, 256)
    t = torch.from_numpy(pm)
    got = cf.force_exact(t[:128].contiguous(), t, G, EPS2).numpy()
    full = cf.force_exact(t, t, G, EPS2).numpy()
    np.testing.assert_array_equal(got, full[:128])


@pytest.mark.parametrize("chunk", [None, 64])
def test_accel_direct_matches_jax(rng, chunk):
    pm = bodies(rng, 256, 230)
    got = accel_direct(torch.from_numpy(pm), G, eps2=EPS2, chunk=chunk).numpy()
    want = np.asarray(jax_accel_direct(jnp.asarray(pm), G, eps2=EPS2, chunk=chunk))
    np.testing.assert_allclose(got, want, **TOL)


def test_accel_partial_matches_jax(rng):
    pm = bodies(rng, 192, 192)
    src = bodies(rng, 128, 128)
    srcT = np.concatenate([src[:, :3].T, G * src[:, 3:4].T], axis=0).astype(np.float32)
    for off, lo, hi in [(0, 0, None), (64, 0, 64), (1 << 30, 0, None)]:
        got = accel_partial(
            torch.from_numpy(pm), torch.from_numpy(srcT), off, eps2=EPS2, diag_lo=lo, diag_hi=hi
        ).numpy()
        want = np.asarray(
            jax_accel_partial(jnp.asarray(pm), jnp.asarray(srcT), off, eps2=EPS2, diag_lo=lo, diag_hi=hi)
        )
        np.testing.assert_allclose(got, want, **TOL)


def test_force_exact_wrapper_checks(rng):
    t = torch.from_numpy(bodies(rng, 64, 64))
    with pytest.raises(TypeError):
        cf.force_exact(t.double(), t.double(), G, EPS2)
    with pytest.raises(ValueError):
        cf.force_exact(t[:, :3], t[:, :3], G, EPS2)
    with pytest.raises(ValueError):
        cf.force_exact(t.t().contiguous().t(), t, G, EPS2)
    with pytest.raises(ValueError):
        cf.force_exact(t, t, G, 0.0)
    with pytest.raises(RuntimeError, match="never take such tensors"):
        cf.force_exact(t.clone().requires_grad_(), t, G, EPS2)
    assert launch_counts()["force_exact"] == 0  # CPU tensors never launch
