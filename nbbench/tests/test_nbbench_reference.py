"""The plain reference against a brute force written out pair by pair, and
the frozen generators against the program's presets."""

import numpy as np
import pytest
import torch

from nbbench.inputs import two_galaxy, uniform_sphere
from nbbench.reference import physics

F64 = torch.float64
G, EPS2 = 1e-4, 1e-4


def _bodies(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (n, 3))
    m = rng.uniform(10, 50, n)
    m[0] = 1e7  # a galaxy's centre among light bodies
    return torch.tensor(x), torch.tensor(m)


def _brute_accel(x, m):
    d = x[None, :, :] - x[:, None, :]
    w = m[None, :] * ((d * d).sum(-1) + EPS2) ** -1.5
    return G * (w[:, :, None] * d).sum(1)


def _brute_potential(x, m):
    r = torch.sqrt(((x[None, :, :] - x[:, None, :]) ** 2).sum(-1) + EPS2)
    phi = -G * (m[None, :] / r)
    phi.fill_diagonal_(0.0)
    return phi.sum(1)


@pytest.mark.parametrize("block", [7, 64])
def test_accel_and_potential_match_the_pair_sum(block):
    x, m = _bodies(64)
    a, phi = physics.accel_potential(x, m, G, EPS2, block=block)
    want = _brute_accel(x, m)
    assert torch.allclose(a, want, rtol=1e-11, atol=1e-11 * float(want.abs().max()))
    assert torch.allclose(phi, _brute_potential(x, m), rtol=1e-11)


def test_lower_precision_force_is_the_same_sum_rounded():
    x, m = _bodies(64)
    want = _brute_accel(x, m)
    got = physics.accel(x, m, G, EPS2, dtype=torch.float32)
    assert torch.allclose(got, want, rtol=1e-3, atol=1e-5 * float(want.abs().max()))
    low = physics.accel(x, m, G, EPS2, dtype=torch.bfloat16)
    err = float((low - want).norm(dim=1).max() / want.norm(dim=1).max())
    assert 1e-5 < err < 0.5


def test_force_vjp_matches_autograd_of_the_pair_sum():
    x, m = _bodies(32, seed=3)
    fbar = torch.tensor(np.random.default_rng(4).normal(size=(32, 3)))
    xr = x.clone().requires_grad_()
    (want,) = torch.autograd.grad((_brute_accel(xr, m) * fbar).sum(), xr)
    # The 1e7 centre's m_j fbar_i - m_i fbar_j terms cancel in the sum:
    # float64 rounding leaves some 1e-9 of the result.
    for block in (5, 32):
        got = physics.force_vjp(x, m, fbar, G, EPS2, block=block)
        assert torch.allclose(got, want, rtol=1e-8, atol=1e-8 * float(want.abs().max()))


def _brute_rollout_loss(x, v, m, dt, k):
    a = torch.zeros_like(x)
    for _ in range(k):
        f = _brute_accel(x, m)
        v = v + (a + f) * (dt / 2)
        x = x + (v + f * (dt / 2)) * dt
        a = f
    return (x * x).sum() / x.shape[0]


@pytest.mark.parametrize("k", [1, 3])
def test_rollout_gradient_matches_autograd(k):
    x, m = _bodies(24, seed=5)
    v = torch.tensor(np.random.default_rng(6).normal(size=(24, 3))) * 5
    dt = 1e-3
    vr = v.clone().requires_grad_()
    (want,) = torch.autograd.grad(_brute_rollout_loss(x, vr, m, dt, k), vr)
    got = physics.rollout_grad(x, v, m, G, EPS2, dt, k)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-12)


def test_follow_is_the_frame_shifted_verlet():
    x, m = _bodies(16, seed=8)
    v = torch.ones_like(x)
    a0 = _brute_accel(x, m) * 0.5
    xs, vs, as_ = physics.follow(x, v, a0, m, G, EPS2, 1e-3, 2)
    xe, ve, ae = x, v, a0
    for _ in range(2):
        f = _brute_accel(xe, m)
        ve = ve + (ae + f) * 5e-4
        xe = xe + (ve + f * 5e-4) * 1e-3
        ae = f
    for got, want in ((xs, xe), (vs, ve), (as_, ae)):
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_energy_terms():
    x, m = _bodies(16, seed=9)
    v = torch.tensor(np.random.default_rng(10).normal(size=(16, 3)))
    a_old = torch.tensor(np.random.default_rng(11).normal(size=(16, 3)))
    dt = 1e-3
    e = physics.energy(x, v, a_old, m, G, EPS2, dt)
    vs = v + (a_old + _brute_accel(x, m)) * (dt / 2)
    assert e["ke"] == pytest.approx(float(0.5 * (m * (vs * vs).sum(1)).sum()), rel=1e-12)
    assert e["pe"] == pytest.approx(float(0.5 * (m * _brute_potential(x, m)).sum()), rel=1e-12)
    assert torch.allclose(e["momentum"], (m[:, None] * vs).sum(0), rtol=1e-12)


def test_energy_is_kept_along_the_reference_trajectory():
    x, m = _bodies(48, seed=12)
    m[0] = 40.0
    v = torch.zeros_like(x)
    dt = 1e-4
    e0 = physics.energy(x, v, torch.zeros_like(x), m, G, EPS2, dt)
    xs, vs, as_ = physics.follow(x, v, torch.zeros_like(x), m, G, EPS2, dt, 64)
    e1 = physics.energy(xs, vs, as_, m, G, EPS2, dt)
    drift = abs(e1["ke"] + e1["pe"] - e0["ke"] - e0["pe"]) / (e1["ke"] + abs(e1["pe"]))
    assert drift < 1e-8


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 17, 3_000_000_001])
def test_frozen_generators_give_the_program_presets(seed):
    from nbody3d_tpu_torch.models.registry import make_preset

    pm, vel = two_galaxy.make({"n": 2 * 51, "G": G, "size_factor": 1000.0}, seed)
    want = make_preset("two-galaxy", seed=seed, G=G, n=2 * 51)
    assert np.array_equal(pm, want[0]) and np.array_equal(vel, want[1])
    pm, vel = uniform_sphere.make({"n": 300}, seed)
    want = make_preset("uniform-sphere", seed=seed, n=300)
    assert np.array_equal(pm, want[0]) and np.array_equal(vel, want[1])
