"""``ops/ewald.py::ewald_potential_energy`` (the periodic energy in torch,
on the input's device and in its dtype) against
``nbody3d_tpu/ops/ewald.py::ewald_potential_energy`` on the CPU.

Tolerances: float64 against the JAX function under x64 to 1e-12 relative
(both sum ~10^5 terms of ~10^4 to a total of ~10^3); autograd's gradient
against ``-m a`` of ``ewald_accel_reference`` to 1e-9 of its scale and
1e-7 relative, as ``tests/test_ewald.py::
test_potential_energy_gradient_is_force`` holds ``jax.grad``; independent of sigma to 1e-6 (the kmax truncation floor, as
``test_potential_energy_sigma_independent``); float32, the port's and the
JAX package's, within ``ewald.energy_f32_bound`` of float64 and of each
other (the f32 phases' rounding, of the size of the self and background
terms the sum cancels against); chunked to 1e-13 relative of unchunked in
float64 (another summation order).

Inputs: random boxes (L = 1, masses U(1, 3)) made with numpy from a seed,
as ``tests/test_ewald.py`` makes them."""

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
    return np.concatenate([rng.uniform(0, L, (n, 3)), rng.uniform(1.0, 3.0, (n, 1))], axis=1)


@pytest.mark.parametrize("n,seed,kw", [(24, 2, dict(sigma=L / 12, kmax=14)), (256, 5, dict(chunk=64)),
                                       (200, 7, dict(eps2=1e-2, sigma=L / 10, kmax=10))])
def test_f64_matches_jax(n, seed, kw):
    pm = rand_box(n, seed)
    with jax.enable_x64(True):
        want = float(jew.ewald_potential_energy(jnp.asarray(pm), L, **kw))
    got = ewald.ewald_potential_energy(torch.from_numpy(pm), L, **kw)
    assert got.dtype == torch.float64 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-12)
    ref = {k: v for k, v in kw.items() if k != "chunk"}
    assert float(got) == pytest.approx(ewald.ewald_potential_energy_f64(pm, L, **ref), rel=1e-12)


def test_gradient_is_the_ewald_force():
    """``-dU/dx = m a``: autograd through the energy against the oracle
    (eps2 tiny: the energy truncates the softening tail at the minimum
    image, the oracle sums its image shells)."""
    pm = torch.from_numpy(rand_box(20, 6))
    sigma = L / 12.0
    x = pm[:, :3].clone().requires_grad_(True)
    u = ewald.ewald_potential_energy(torch.cat([x, pm[:, 3:]], dim=1), L, eps2=1e-9, sigma=sigma, kmax=14)
    (g,) = torch.autograd.grad(u, x)
    f = pm[:, 3:] * ewald.ewald_accel_reference(pm, L, sigma, eps2=1e-9, n_images=2, kmax=14)
    scale = float(f.abs().max())
    # test_ewald.py's tolerance: atol 1e-9 of scale with assert_allclose's rtol 1e-7 (the JAX grad
    # is 1.49e-9 of scale off its own oracle on this state, the port's 7e-16 off the JAX grad)
    np.testing.assert_allclose(-g.numpy() / scale, f.numpy() / scale, atol=1e-9)


def test_sigma_independent():
    pm = torch.from_numpy(rand_box(24, 2))
    u1 = float(ewald.ewald_potential_energy(pm, L, eps2=1e-4, sigma=L / 10, kmax=12))
    u2 = float(ewald.ewald_potential_energy(pm, L, eps2=1e-4, sigma=L / 14, kmax=16))
    assert u1 == pytest.approx(u2, rel=1e-6)


@pytest.mark.parametrize("n,seed", [(256, 3), (512, 4)])
def test_f32_within_the_rounding_bound(n, seed):
    """The default split (sigma = L/16, kmax = 16) in float32: the port's
    and the JAX package's energy each within the bound of float64, and of
    each other."""
    pm = rand_box(n, seed).astype(np.float32)
    u64 = ewald.ewald_potential_energy_f64(pm, L)
    bound = ewald.energy_f32_bound(pm, L)
    got = ewald.ewald_potential_energy(torch.from_numpy(pm), L, chunk=128)
    assert got.dtype == torch.float32
    want = float(jew.ewald_potential_energy(jnp.asarray(pm), L))
    errs = abs(float(got) - u64), abs(want - u64), abs(float(got) - want)
    assert max(errs) <= bound, (errs, bound)


def test_chunked_equals_unchunked():
    pm = torch.from_numpy(rand_box(96, 8))
    whole = float(ewald.ewald_potential_energy(pm, L))
    for chunk in (8, 32, 48, 96, 200):
        assert float(ewald.ewald_potential_energy(pm, L, chunk=chunk)) == pytest.approx(whole, rel=1e-13)
    with pytest.raises(ValueError, match="chunk 36 must divide N 96"):
        ewald.ewald_potential_energy(pm, L, chunk=36)
