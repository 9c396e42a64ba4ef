"""``ops/ewald.py`` of the port against ``nbody3d_tpu/ops/ewald.py`` on the
CPU: the split scalars to f32 rounding of their terms (``erf(u) - (2/sqrt
pi) u e^{-u²}`` cancels at small u, so both packages are held to 8 ulp of
the terms they subtract, not of the result, against the f64 value), the
spectral solve to 1e-5 of its max, the wrap bit for bit,
the f64 Ewald energy to 1e-12 relative, and the f64 oracle to 1e-9 of its
scale (both sum ~10^5 f64 terms a body in different orders), with its
independence of the split width and its row batches.

Inputs: a random box (L = 1, masses U(1, 3)) made with numpy from a seed,
as ``tests/test_periodic.py`` makes it."""

import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.ewald as jew  # noqa: E402
from nbody3d_tpu_torch.ops import ewald  # noqa: E402

L = 1.0


def rand_box(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, L, (n, 3)), rng.uniform(1.0, 3.0, (n, 1))], axis=1).astype(np.float32)


def r2_samples(seed=0):
    """Squared separations from 0 (the masked pair) to ~L², log-spread."""
    r = np.concatenate([[0.0], 10.0 ** np.random.default_rng(seed).uniform(-4, 0, 511)])
    return (r * r).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.02, 0.1])
@pytest.mark.parametrize("fn", ["k_long_gauss", "k_short_periodic"])
def test_split_scalars_match_jax(fn, sigma):
    r2 = r2_samples()
    args = (1e-4,) if fn == "k_short_periodic" else ()
    got = getattr(ewald, fn)(torch.from_numpy(r2), *args, torch.tensor(sigma)).numpy()
    want = np.asarray(getattr(jew, fn)(jnp.asarray(r2), *args, jnp.float32(sigma)))
    assert got[0] == 0.0 and want[0] == 0.0
    r = np.sqrt(r2[1:].astype(np.float64))
    u = r / (np.sqrt(2.0) * sigma)
    erf_u, gauss = np.vectorize(math.erf)(u), 1.1283791670955126 * u * np.exp(-u * u)
    exact, terms = (erf_u - gauss) / r**3, (erf_u + gauss) / r**3
    if args:
        exact = (r * r + args[0]) ** -1.5 - exact
        terms += (r * r + args[0]) ** -1.5
    for value in (got, want):
        assert np.all(np.abs(value[1:] - exact) <= 8 * 2.0**-24 * terms)


@pytest.mark.parametrize("order,grid", [(2, 16), (3, 16), (3, 32)])
def test_spectral_accel_grids_match_jax(order, grid):
    rho = np.random.default_rng(grid + order).uniform(0.0, 3.0, (grid, grid, grid)).astype(np.float32)
    sigma = 1.5 * L / grid
    got = ewald.spectral_accel_grids(torch.from_numpy(rho), L, torch.tensor(sigma), order=order).numpy()
    want = np.asarray(jew.spectral_accel_grids(jnp.asarray(rho), L, jnp.float32(sigma), order=order))
    assert got.shape == want.shape == (3, grid**3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_wrap_box_matches_jax():
    pos = np.random.default_rng(3).uniform(-2.5 * L, 3.5 * L, (4096, 3)).astype(np.float32)
    pos[:4] = [[0.0, -0.0, L], [-1e-9, 1e-9, 2 * L], [-L, 3 * L, -3 * L], [0.5, 0.25, 0.75]]
    got = ewald.wrap_box(torch.from_numpy(pos), 10.0 * L / 10.0).numpy()
    want = np.asarray(jew.wrap_box(jnp.asarray(pos), L))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= L


@pytest.mark.parametrize("sigma,kmax", [(None, None), (0.08, 12)])
def test_ewald_energy_f64_matches_jax(sigma, kmax):
    pm = rand_box(300, seed=2)
    got = ewald.ewald_potential_energy_f64(pm, L, eps2=1e-4, sigma=sigma, kmax=kmax)
    want = jew.ewald_potential_energy_f64(pm, L, eps2=1e-4, sigma=sigma, kmax=kmax)
    assert abs(got - want) <= 1e-12 * abs(want)


def _jax_oracle(pm, sigma, eps2, kmax):
    with jax.enable_x64(True):
        return np.asarray(jew.ewald_accel_reference(jnp.asarray(pm, np.float64), L, sigma, eps2=eps2, n_images=2,
                                                    kmax=kmax))


def test_ewald_oracle_matches_jax():
    pm = rand_box(256, seed=1)
    sigma = 1.5 * L / 32
    want = _jax_oracle(pm, sigma, 1e-6, 10)
    got = ewald.ewald_accel_reference(torch.from_numpy(pm).double(), L, sigma, eps2=1e-6, n_images=2,
                                      kmax=10).numpy()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    rows = torch.tensor([0, 7, 100, 255])
    part = ewald.ewald_accel_reference(torch.from_numpy(pm).double(), L, sigma, eps2=1e-6, n_images=2, kmax=10,
                                       rows=rows, pair_batch=3000).numpy()
    assert np.abs(part - want[rows.numpy()]).max() <= 1e-9 * np.abs(want).max()


def test_ewald_oracle_is_independent_of_sigma():
    """The split width moves terms between real and reciprocal space and
    leaves the sum (to the truncation of both)."""
    pm = torch.from_numpy(rand_box(128, seed=4)).double()
    a = ewald.ewald_accel_reference(pm, L, 0.06, eps2=1e-4, n_images=2, kmax=16)
    b = ewald.ewald_accel_reference(pm, L, 0.09, eps2=1e-4, n_images=2, kmax=12)
    assert float((a - b).abs().max()) <= 1e-8 * float(a.abs().max())
