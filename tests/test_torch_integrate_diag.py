"""Integrators, diagnostics and Morton ordering: port vs JAX package."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.ops import diagnostics as jdiag  # noqa: E402
from nbody3d_tpu.ops import integrate as jint  # noqa: E402
from nbody3d_tpu.ops import morton as jmorton  # noqa: E402
from nbody3d_tpu_torch.ops import diagnostics as tdiag  # noqa: E402
from nbody3d_tpu_torch.ops import integrate as tint  # noqa: E402
from nbody3d_tpu_torch.ops import morton as tmorton  # noqa: E402

SPRING = np.array([1.0, 1.0, 1.0, 0.0], np.float32)


def state_arrays(rng, n, n_real=None):
    pm = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(1, 50, (n, 1))], 1).astype(np.float32)
    vel = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], 1).astype(np.float32)
    acc = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], 1).astype(np.float32)
    if n_real is not None:
        pm[n_real:] = 0.0
    return pm, vel, acc


@pytest.mark.parametrize("kind", ["verlet", "euler", "yoshida4"])
@pytest.mark.parametrize("n_real", [None, 50])
def test_integrate_from_accum_bit_equal(rng, kind, n_real):
    """Same inputs and the same (linear, exactly representable) force give
    the JAX package's update bit for bit: the op order is the same."""
    n = 64
    pm, vel, acc = state_arrays(rng, n)
    dt = 3.7e-3
    valid_t = tint.valid_mask(n, n_real, "cpu")
    valid_j = None if valid_t is None else jnp.asarray(valid_t.numpy())
    spring_t = torch.from_numpy(SPRING)
    got = tint.integrate_from_accum(
        kind, lambda p: -(p * spring_t), *(torch.from_numpy(x) for x in (pm, vel, acc)), dt, valid_t
    )
    want = jint.integrate_from_accum(
        kind, lambda p: -(p * jnp.asarray(SPRING)), *(jnp.asarray(x) for x in (pm, vel, acc)), dt, valid_j
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_integrate_state_steps_and_masks(rng):
    from nbody3d_tpu_torch.state import init_state

    pm, vel, acc = state_arrays(rng, 10)
    s = init_state(pm, vel, acc, n_pad=16, device="cpu")
    out = tint.integrate_state("verlet", lambda p: torch.ones_like(p), s, 1e-2, n_real=10)
    assert out.step == 1
    np.testing.assert_array_equal(out.pos_mass[10:].numpy(), 0.0)
    np.testing.assert_array_equal(out.accel[10:].numpy(), 0.0)
    with pytest.raises(ValueError):
        tint.apply_integrator("leapfrog", s.pos_mass, s.vel, s.accel, s.accel, 1e-3)


@pytest.mark.parametrize("chunk", [None, 32])
def test_diagnostics_match_jax(rng, chunk):
    pm, vel, _ = state_arrays(rng, 128, n_real=120)
    got = tdiag.compute(torch.from_numpy(pm), torch.from_numpy(vel), 1e-4, eps2=1e-4, chunk=chunk)
    want = jdiag.compute(jnp.asarray(pm), jnp.asarray(vel), 1e-4, eps2=1e-4, chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    com_t = tdiag.center_of_mass(torch.from_numpy(pm)).numpy()
    np.testing.assert_allclose(com_t, np.asarray(jdiag.center_of_mass(jnp.asarray(pm))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,n_real", [(256, 256), (256, 200), (1000, 999)])
def test_morton_keys_and_order_equal(rng, n, n_real):
    pm, vel, acc = state_arrays(rng, n, n_real=n_real)
    nr = None if n_real == n else n_real
    kt = tmorton.morton_keys(torch.from_numpy(pm), nr).numpy()
    kj = np.asarray(jmorton.morton_keys(jnp.asarray(pm), nr))
    np.testing.assert_array_equal(kt, kj)
    if nr is not None:
        assert (kt[n_real:] == 0x7FFFFFFF).all()
    ot = tmorton.morton_order(torch.from_numpy(pm), nr).numpy()
    np.testing.assert_array_equal(ot, np.argsort(kj, kind="stable"))
    got = tmorton.morton_reorder(*(torch.from_numpy(x) for x in (pm, vel, acc)), n_real=nr)
    want = jmorton.morton_reorder(*(jnp.asarray(x) for x in (pm, vel, acc)), n_real=nr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
