"""``ops/ewald.py`` of the port against ``nbody3d_tpu/ops/ewald.py`` on the
CPU: the split scalars to f32 rounding of their terms (``erf(u) - (2/sqrt
pi) u e^{-u²}`` cancels at small u, so both packages are held to 8 ulp of
the terms they subtract, not of the result, against the f64 value; the
port's own k, which takes k_long's series below u = 0.5, also to 8 ulp of
``s⁻³ + k_long`` against mpmath down to r = 1e-6 σ), the
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
from nbody3d_tpu_torch.ops import ewald, p3m  # noqa: E402

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


def _k_long_mp(r: float, sigma: float) -> float:
    """k_long at r in 40-digit arithmetic (no cancellation survives)."""
    mpmath = pytest.importorskip("mpmath")
    with mpmath.workdps(40):
        r = mpmath.mpf(r)
        u = r / (mpmath.sqrt(2) * mpmath.mpf(sigma))
        return float((mpmath.erf(u) - 2 / mpmath.sqrt(mpmath.pi) * u * mpmath.exp(-u * u)) / r**3)


# σ of the periodic P3M cells: grid 128 in a unit box (13a), grid 32 in a
# unit box (12c), grid 16 (the tests' box); p3m_bench's eps2 and a smaller one.
@pytest.mark.parametrize("eps2", [1e-4, 1e-6])
@pytest.mark.parametrize("sigma", [1.5 / 128, 1.25 / 32, 1.5 / 16])
def test_periodic_k_within_8_ulp_of_f64(sigma, eps2):
    """The twin's ``k_long_gauss``, ``k_short_periodic`` and the backward
    twin's k (``p3m._k_short_periodic_grads``, the kernels' arithmetic) in
    f32 against mpmath from r = 1e-6 σ to rcut = 4.5 σ: within 8 ulp
    (2^-24) of ``s⁻³ + k_long``.  Before k_long took its series below u =
    0.5 the closed form cancelled to an error of order 1/(σ r²), and at
    r = 1e-6 σ k was off by far more than its size."""
    sig32 = float(np.float32(sigma))
    r = sig32 * np.geomspace(1e-6, 4.5, 400)
    r2 = (r * r).astype(np.float32)
    rr = np.sqrt(r2.astype(np.float64))
    k_long = np.array([_k_long_mp(x, sig32) for x in rr])
    inv_s3 = (rr * rr + eps2) ** -1.5
    allow = 8 * 2.0**-24 * (inv_s3 + k_long)
    r2t, st = torch.from_numpy(r2), torch.tensor(sig32)
    for name, got, want in (
        ("k_long_gauss", ewald.k_long_gauss(r2t, st), k_long),
        ("k_short_periodic", ewald.k_short_periodic(r2t, eps2, st), inv_s3 - k_long),
        ("_k_short_periodic_grads k", p3m._k_short_periodic_grads(r2t, eps2, st)[0], inv_s3 - k_long),
    ):
        err = np.abs(got.double().numpy() - want)
        print(f"sigma {sig32:.4f} eps2 {eps2:g} {name}: worst {float((err / allow).max()) * 8:.2f} ulp")
        assert np.all(err <= allow), name


def test_k_long_series_meets_closed_form():
    """The series and the closed form of k_long agree where they meet: in
    f64 at u = 0.2 and at the switch u = 0.5 within 5e-12 relative (the
    series' truncation is 2e-12 at u = 0.5, the closed form's f64
    cancellation ~1e-14), ``k_long_gauss`` on both sides of the switch
    too, and in f32 the values just below and just above the switch within
    8 ulp (no step at the switch beyond rounding)."""
    sigma = 0.05
    a = 1.0 / (np.sqrt(2.0) * sigma)
    for u in (0.2, 0.5 * (1 - 1e-9), 0.5, 0.5 * (1 + 1e-9)):
        r = u / a
        closed = (math.erf(u) - 2 / np.sqrt(np.pi) * u * math.exp(-u * u)) / r**3
        series = float(ewald.k_long_series(2 / np.sqrt(np.pi) * a, a * a, torch.tensor(u * u, dtype=torch.float64)))
        assert abs(series - closed) <= 5e-12 * closed, u
        got = float(ewald.k_long_gauss(torch.tensor(r * r, dtype=torch.float64), sigma))
        assert abs(got - closed) <= 5e-12 * closed, u
    r_sw = np.float32(0.5 / a)
    r2 = torch.tensor([np.nextafter(r_sw, 0) ** 2, r_sw**2, np.nextafter(r_sw, 1) ** 2], dtype=torch.float32)
    k = ewald.k_long_gauss(r2, torch.tensor(sigma, dtype=torch.float32)).double()
    assert float((k - k[1]).abs().max()) <= 8 * 2.0**-24 * float(k[1])


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
