"""Gradients through the periodic box (``boundary="periodic"``) of the port
against the JAX package on the CPU: the periodic pair derivatives
(``p3m._k_short_periodic_grads``, the arithmetic of the periodic
``short_range_bwd``) against float64, the periodic short-range backward twin
against ``jax.grad`` of ``short_range_tiles(box=L)`` (the Pallas backward in
interpret mode and the jnp form) and against f64 autograd on planted close
pairs, where the JAX Pallas backward's cancelling k' shows; the periodic mesh
autograd Functions (``gradcheck`` in float64), the periodic mesh leg's and the
spectral solve's gradients against JAX; 3-step rollout gradients through
``make_step_fn`` (by v0, dt and G) against ``jax.grad`` through the JAX step,
and a backward through ``Simulation``'s step.

Inputs are unit boxes made with numpy from a seed, with bodies planted on the
seams (``test_torch_periodic.box_scene``).  Bounds: the JAX tests' gradient
bounds (``tests/test_p3m.py:476-491``: rtol 1e-4 with atol 1e-5 of the
scale, σ̄ rel 1e-3; ``tests/test_mesh_pallas.py:471-472`` for the mesh leg),
the mesh rollout bound (rtol 2e-3, v0's atol 1e-6 of the scale,
``tests/test_torch_p3m_grad.py``) and 1e-6
of f64 for the pair derivatives."""

import functools
import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_periodic import L, box_scene, jax_select, sorted_box  # noqa: E402

import nbody3d_tpu.ops.ewald as jewald  # noqa: E402
import nbody3d_tpu.ops.mesh_pallas as jmp  # noqa: E402
import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import SimState as JaxState  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation  # noqa: E402
from nbody3d_tpu_torch.ops import ewald, p3m, pm  # noqa: E402
from nbody3d_tpu_torch.ops import mesh_cuda as mc  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close(got, want, rtol=1e-4, atol_scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max())


def min_image_np(d):
    return d - L * np.round(d / L)


def closest_pair(ps_np):
    d = min_image_np(ps_np[None, :, :3].astype(np.float64) - ps_np[:, None, :3])
    r = np.sqrt(np.sum(d * d, axis=-1))
    r[np.diag_indices_from(r)] = np.inf
    return float(r.min())


# ------------------------------------------------------- pair derivatives
def _kp_terms_f64(r2, eps2, sigma):
    """The sum of the magnitudes of the two parts that the k' formula
    subtracts, in f64: ``1.5/s⁵ + |series|`` below u = 0.2, ``1.5(1/r⁵ -
    1/s⁵) + (1.5 erfc(u)/r⁵ + 1.5 c2 e/r⁴ + c2 a² e/r²)`` above.  f32 can
    do no better than rounding each part: where they cancel (k' heads for
    its zero near rcut) the error is a fraction of this sum, not of k'."""
    x, y = r2 ** -0.5, (r2 + eps2) ** -0.5
    a = 1 / (np.sqrt(2) * sigma)
    c2, u2 = 2 / np.sqrt(np.pi) * a, r2 * a * a
    series = c2 * a**4 * torch.abs(-0.4 + u2 * (2 / 7 + u2 * (-1 / 9 + u2 / 33)))
    gauss = 1.5 * torch.special.erfc(torch.sqrt(u2)) * x**5 + c2 * torch.exp(-u2) * x * x * (1.5 * x * x + a * a)
    return torch.where(u2 < 0.04, 1.5 * y**5 + series, 1.5 * (x**5 - y**5) + gauss)


@pytest.mark.parametrize("sigma,eps2", [(1.5 * 10 / 128, 1e-4), (1.5 / 16, 1e-6)])
def test_k_short_periodic_grads_match_f64(sigma, eps2):
    """``(k', k_σ)`` in f32 against float64 for r from 1e-5 to rcut
    (p3m_bench's periodic σ and eps2, and the tests' grid-16 box): k_σ
    within 1e-6 relative; k' within 1e-6 of the larger of |k'| and half
    the sum of its formula's two parts (:func:`_kp_terms_f64`), which is
    1e-6 relative wherever the parts do not cancel, down to r = 1e-5 (near
    rcut, where k' nears its zero, the parts cancel and a relative bound
    means nothing).  The reference: f64 autograd of ``ewald.k_short_periodic``
    for r >= 1e-3 (exact to ~1e-12 there); below, the same formulas in
    f64 (the series' truncation is 2e-8).  k is the forward's f32 formula
    (``csrc/periodic.cuh``, not this test's subject): its error is printed."""
    sig32 = torch.tensor(sigma, dtype=torch.float32)
    rcut = 4.5 * float(sig32)
    r2 = torch.from_numpy(np.geomspace(1e-5, rcut, 3000) ** 2).float()
    k, kp, ks = (x.double() for x in p3m._k_short_periodic_grads(r2, eps2, sig32))

    q = r2.double().requires_grad_()
    s64 = torch.full_like(q, float(sig32)).requires_grad_()  # elementwise: one σ derivative a pair
    k_ad = ewald.k_short_periodic(q, eps2, s64)
    kp_ad, ks_ad = torch.autograd.grad(k_ad.sum(), (q, s64))
    _, kp_f, ks_f = p3m._k_short_periodic_grads(r2.double(), eps2, sig32.double())
    r = r2.double().sqrt()
    far = r >= 1e-3
    kp_ref = torch.where(far, kp_ad, kp_f)
    ks_ref = torch.where(far, ks_ad, ks_f)
    # Where both references are valid they agree far below the bound.
    assert float(((kp_ad - kp_f).abs() / kp_ad.abs())[far].max()) < 1e-9
    terms = _kp_terms_f64(r2.double(), eps2, float(sig32))
    e_kp = (kp - kp_ref).abs() / torch.maximum(kp_ref.abs(), 0.5 * terms)
    e_rel = (kp - kp_ref).abs() / kp_ref.abs()
    e_ks = ((ks - ks_ref).abs() / ks_ref.abs()).max()
    e_k = ((k - k_ad.detach()).abs() / k_ad.detach().abs()).max()
    print(f"sigma {sigma:.4f} eps2 {eps2:g}: k' err / max(|k'|, parts/2) {float(e_kp.max()):.3e}, relative "
          f"{float(e_rel.max()):.3e} (r <= 0.3: {float(e_rel[r <= 0.3].max()):.3e}); k_sigma relative "
          f"{float(e_ks):.3e}; k (the forward's) relative {float(e_k):.3e}")
    assert e_kp.max() <= 1e-6 and e_ks <= 1e-6
    assert e_rel[r <= 0.3].max() <= 1e-6


# ------------------------------------------------------- short-range backward
def _periodic_lists(jps, n, block, nbr_k):
    h = jnp.float32(L / 16)
    sigma, rcut = 1.5 * h, 4.5 * 1.5 * h
    lo_b, hi_b = jp3m._sorted_aabbs(jps, n, block)
    kth, neg, idx = jax_select(lo_b, hi_b, h, nbr_k, jnp.float32(L))
    return idx, jp3m.mutual_neighbor_mask(neg, idx, kth), sigma, rcut


@pytest.mark.parametrize("block,nbr_k", [(64, 4), (32, 8)])
def test_periodic_short_range_bwd_twin_matches_jax(block, nbr_k):
    """The periodic backward twin (what ``short_range_bwd`` runs on CPU
    tensors, and ``_ShortRange``'s backward with the box) against
    ``jax.grad`` of ``short_range_tiles(box=L)`` on the Pallas backend
    (interpret mode: the Pallas backward kernel) and the jnp form, for a
    random-weight loss, by the sorted rows and σ: rtol 1e-4, atol 1e-5 of
    the scale, σ̄ rel 1e-3.  The scene's closest pair is above 0.01σ,
    where JAX's f32 derivative is good to ~1e-6 of a pair's x̄ term."""
    n, eps2 = 512, 1e-6
    ps = sorted_box(box_scene(n, seed=7), n)
    jps = jnp.asarray(ps)
    nb = n // block
    idx, mask, sigma, rcut = _periodic_lists(jps, n, block, nbr_k)
    assert closest_pair(ps) > 0.01 * float(sigma)
    w = np.random.default_rng(5).standard_normal((n, 4)).astype(np.float32)
    w[:, 3] = 0.0

    def jloss(backend):
        def f(p, s):
            out = jp3m.short_range_tiles(p, idx, 0, nb, eps2, s, rcut, block, nbr_mask=mask, backend=backend,
                                         interpret=True, box=jnp.float32(L))
            return jnp.sum(out[:, :3] * jnp.asarray(w[:, :3]))
        return f

    tps, tidx, tmask = t(ps), torch.from_numpy(np.array(idx)), t(mask)
    tsig, trcut = torch.tensor(float(sigma)), torch.tensor(float(rcut))
    got, got_sig = p3m.short_range_tiles_bwd(tps, t(w), tidx, eps2, tsig, trcut, block, tmask, box=L)
    assert got[:, :3].abs().max() > 0 and got[:, 3].abs().max() > 0
    for backend in ("pallas", "jnp"):
        want, want_sig = jax.grad(jloss(backend), argnums=(0, 1))(jps, sigma)
        want = np.asarray(want)
        assert_close(got[:, :3], want[:, :3])
        assert_close(got[:, 3], want[:, 3])
        assert float(got_sig) == pytest.approx(float(want_sig), rel=1e-3)

    ps_, sig_ = tps.clone().requires_grad_(), tsig.clone().requires_grad_()
    out = p3m._ShortRange.apply(ps_, sig_, trcut, tidx, tmask, eps2, block, "auto", L)
    auto, auto_sig = torch.autograd.grad(out, (ps_, sig_), t(w))
    assert torch.equal(auto, got) and torch.equal(auto_sig, got_sig)


def planted_scene(r, seed=11):
    """256 bodies in the unit box (masses U(1, 3)) and one planted pair at
    separation ``r`` along x, across the seam (x = r/2 and L - r/2) when
    ``r`` is 1e-5; sorted.  ``(ps, rows of the pair in sorted order)``."""
    rng = np.random.default_rng(seed)
    pm_np = np.concatenate([rng.uniform(0.05, 0.95, (256, 3)), rng.uniform(1.0, 3.0, (256, 1))], 1)
    if r < 1e-4:
        pm_np[:2, :3] = [[r / 2, 0.41, 0.63], [L - r / 2, 0.41, 0.63]]
    else:
        pm_np[:2, :3] = [[0.37, 0.52, 0.48], [0.37 + r, 0.52, 0.48]]
    pm_np = pm_np.astype(np.float32)
    keys = p3m.morton_keys(torch.from_numpy(pm_np), 256)
    order = torch.argsort(keys, stable=True).numpy()
    ps = pm_np[order]
    return ps, [int(np.nonzero(order == 0)[0][0]), int(np.nonzero(order == 1)[0][0])]


def _bwd_setup(ps, block=64, grid=16):
    n = ps.shape[0]
    nb = n // block
    sigma = 1.5 * L / grid
    idx = torch.arange(nb).repeat(nb, 1)  # every tile lists every tile: all pairs within rcut
    return dict(idx=idx, mask=torch.ones((nb, nb)), sigma=sigma, rcut=4.5 * sigma, block=block)


def _f64_vjp(ps, g, x, eps2):
    """f64 autograd through the forward twin: the exact VJP."""
    p64 = torch.from_numpy(ps).double().requires_grad_()
    s64 = torch.tensor(x["sigma"], dtype=torch.float64, requires_grad=True)
    out = p3m._short_range_tiles(p64, x["idx"], eps2, s64, torch.tensor(x["rcut"], dtype=torch.float64),
                                 x["block"], x["mask"].double(), box=L)
    return torch.autograd.grad(out, (p64, s64), g.double())


@pytest.mark.parametrize("r", [1e-3, 1e-4, 1e-5])
def test_periodic_short_range_bwd_on_planted_pair_matches_f64(r):
    """At a planted pair of separation r (1e-5 across the seam), eps2 =
    1e-4 and σ = 0.094, the twin's x̄ and m̄ of the pair's rows against f64
    autograd through the forward twin: within 1e-5 of the row plus the f32
    rounding of the forward's k (4 ulp of ``s⁻³ + k_long``, times
    |m_i g_j - m_j g_i|), which the backward shares: with k_long by its
    series below u = 0.5 nothing cancels at r << σ (before, the allowance
    had to be 4 ulp of the cancelling terms erf(u)/r³ and c2 e/r², which
    grow as 1/r²).  m̄ takes k (d·g_j), so its allowance adds the f32
    rounding of d itself: 1 ulp of the raw difference x_j - x_i before the
    image shift, which is about L for the pair across the seam (both
    packages compute d so).  Each allowance is below the one it replaces at
    every r.  k' enters at 1e-6 of f64 (its weight in the row is
    |2k'r²/k| <= 3e-4 here); the rows away from the pair within 1e-5 of the
    scale.  σ̄ rel 1e-4."""
    eps2 = 1e-4
    ps, pair = planted_scene(r)
    x = _bwd_setup(ps)
    g = torch.from_numpy(np.random.default_rng(12).standard_normal((ps.shape[0], 4)).astype(np.float32))
    g[:, 3] = 0.0
    got, got_sig = p3m.short_range_tiles_bwd(t(ps), g, x["idx"], eps2, torch.tensor(x["sigma"]),
                                             torch.tensor(x["rcut"]), x["block"], x["mask"], box=L)
    want, want_sig = _f64_vjp(ps, g, x, eps2)
    d = min_image_np(ps[pair[1], :3].astype(np.float64) - ps[pair[0], :3])
    assert abs(np.linalg.norm(d) - r) < 1e-2 * r
    k_long = float(ewald.k_long_gauss(torch.tensor(r * r, dtype=torch.float64), x["sigma"]))
    terms = (r * r + eps2) ** -1.5 + k_long
    ulp = 2.0**-24
    got, want = got.double().numpy(), want.numpy()
    for i, j in (pair, pair[::-1]):
        mg = np.linalg.norm(ps[i, 3] * g[j, :3].numpy() - ps[j, 3] * g[i, :3].numpy())
        err = np.linalg.norm(got[i, :3] - want[i, :3])
        bound = 1e-5 * np.linalg.norm(want[i, :3]) + 4 * ulp * terms * mg
        print(f"r={r:g} row {i}: |x̄ - f64| {err:.3e} <= {bound:.3e} (|x̄| {np.linalg.norm(want[i, :3]):.3e}, "
              f"{err / bound:.3f} of the bound)")
        assert err <= bound
        e_m = abs(got[i, 3] - want[i, 3])
        raw = ps[j, :3].astype(np.float64) - ps[i, :3]
        gj = g[j, :3].numpy()
        assert e_m <= (1e-5 * abs(want[i, 3]) + 4 * ulp * terms * abs(float(np.dot(d, gj)))
                       + ulp * terms * float(np.dot(np.abs(raw), np.abs(gj))))
    rest = np.setdiff1d(np.arange(ps.shape[0]), pair)
    assert_close(got[rest, :3], want[rest, :3])
    assert float(got_sig) == pytest.approx(float(want_sig), rel=1e-4)


def test_jax_periodic_backward_errs_at_close_pair():
    """The reference's fault, not inherited: at a pair 3e-4 apart (eps2 =
    1e-4, σ = 0.094), the JAX Pallas periodic backward
    (``_short_range_tiles_bwd_pallas``, interpret mode) takes k' as a sum of
    c2/r⁴-sized terms with the A-S erfc, and errs on the pair's rows by far
    more than the twin does (both against f64 autograd); the test prints
    both errors."""
    eps2 = 1e-4
    ps, pair = planted_scene(3e-4)
    x = _bwd_setup(ps)
    nb = ps.shape[0] // x["block"]
    g = torch.from_numpy(np.random.default_rng(13).standard_normal((ps.shape[0], 4)).astype(np.float32))
    g[:, 3] = 0.0
    want, _ = _f64_vjp(ps, g, x, eps2)
    got, _ = p3m.short_range_tiles_bwd(t(ps), g, x["idx"], eps2, torch.tensor(x["sigma"]),
                                       torch.tensor(x["rcut"]), x["block"], x["mask"], box=L)
    jax_dps, _ = jp3m._short_range_tiles_bwd_pallas(
        jnp.asarray(ps), jnp.asarray(g[:, :3].numpy()), jnp.asarray(x["idx"].numpy()), nb, eps2,
        jnp.float32(x["sigma"]), jnp.float32(x["rcut"]), x["block"], jnp.asarray(x["mask"].numpy()),
        interpret=True, box=jnp.float32(L))
    want = want.numpy()[pair, :3]
    scale = np.linalg.norm(want, axis=1)
    e_twin = float(np.max(np.linalg.norm(got.double().numpy()[pair, :3] - want, axis=1) / scale))
    e_jax = float(np.max(np.linalg.norm(np.asarray(jax_dps, np.float64)[pair, :3] - want, axis=1) / scale))
    print(f"r = 3e-4 pair rows, |x̄ - f64| / |x̄|: port twin {e_twin:.3e}, JAX Pallas backward {e_jax:.3e}")
    assert e_twin < 1e-4 < e_jax and e_jax > 10 * e_twin


# ------------------------------------------------------------- mesh VJPs
def _seam_cells(order, n=24, grid=8, seed=2):
    pm_np = box_scene(n, seed=seed).astype(np.float64)
    cells = p3m._tsc_cells if order == 3 else pm._cic_cells
    pos = torch.from_numpy(pm_np[:, :3])
    c, f = cells(pos, torch.zeros(3, dtype=torch.float64), torch.tensor(L / grid, dtype=torch.float64), grid,
                 periodic=True)
    return mc.mesh_operands(c, f, torch.from_numpy(pm_np[:, 3])), grid


@pytest.mark.parametrize("which,order", [("short_range", None), ("deposit", 3), ("deposit", 2), ("gather", 3),
                                         ("gather", 2)])
def test_periodic_autograd_functions_backward(which, order):
    """Each periodic autograd Function's backward: ``deposit_diff`` and
    ``gather_diff`` with ``periodic=True`` pass ``torch.autograd.gradcheck``
    in float64 (the twins on CPU tensors) at TSC and CIC, on seam bodies
    whose stencils wrap; ``_ShortRange`` with the box matches autograd
    through the forward twin (rtol 1e-4, atol 1e-5 of the scale, σ̄ rel
    1e-3) on a box with no massless body (the forward twin leaves massless
    sources out, so autograd through it gives them no m̄)."""
    if which == "short_range":
        ps = sorted_box(box_scene(512, seed=9), 512)
        block, nb = 64, ps.shape[0] // 64
        idx, mask = torch.arange(nb).repeat(nb, 1), torch.ones((nb, nb))
        sigma, rcut = torch.tensor(1.5 / 16), torch.tensor(4.5 * 1.5 / 16)
        g = torch.from_numpy(np.random.default_rng(4).standard_normal(ps.shape).astype(np.float32))
        ps_, sig_ = t(ps).requires_grad_(), sigma.clone().requires_grad_()
        out = p3m._ShortRange.apply(ps_, sig_, rcut, idx, mask, 1e-6, block, "auto", L)
        got = torch.autograd.grad(out, (ps_, sig_), g)
        ps_, sig_ = t(ps).requires_grad_(), sigma.clone().requires_grad_()
        want = torch.autograd.grad(p3m._short_range_tiles(ps_, idx, 1e-6, sig_, rcut, block, mask, box=L),
                                   (ps_, sig_), g)
        assert_close(got[0][:, :3], want[0][:, :3])
        assert_close(got[0][:, 3], want[0][:, 3])
        assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-3)
        return
    (c4, fm), grid = _seam_cells(order)
    assert ((c4[:, :3] == 0) | (c4[:, :3] == grid - 1)).any()  # stencils that wrap
    fm = fm.clone().requires_grad_()
    if which == "deposit":
        assert torch.autograd.gradcheck(lambda f: mc.deposit_diff(c4, f, grid, order, periodic=True), (fm,),
                                        fast_mode=True)
    else:
        grids = torch.from_numpy(np.random.default_rng(6).standard_normal((3, grid**3))).requires_grad_()
        assert torch.autograd.gradcheck(lambda gr, f: mc.gather_diff(gr, c4, f, grid, order, periodic=True),
                                        (grids, fm), fast_mode=True)


@pytest.fixture(scope="module")
def scene_small():
    return sorted_box(box_scene(500, 512, seed=9), 500)


@pytest.mark.parametrize("order", [3, 2])
def test_periodic_mesh_leg_grad_matches_jax(scene_small, order):
    """The gradient of ``sum(a²)`` of ``periodic_mesh_leg`` (deposit,
    spectral solve, gather through the autograd Functions) by positions and
    masses against ``jax.grad`` of ``mesh_accel_periodic(backend="jnp")``
    at orders 3 and 2: rtol 1e-4, atol 1e-5 of the scale
    (``tests/test_mesh_pallas.py:471-472``)."""
    grid = 32
    sigma = 1.5 * L / grid

    def jloss(x):
        a = jmp.mesh_accel_periodic(x, jnp.float32(L), jnp.float32(sigma), grid=grid, block=256, order=order,
                                    backend="jnp")
        return jnp.sum(a[:, :3] * a[:, :3])

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(scene_small)))
    x = t(scene_small).requires_grad_()
    a = p3m.periodic_mesh_leg(x[:, :3], x[:, 3], torch.tensor(L), torch.tensor(sigma), grid, order, plain=False)
    got, = torch.autograd.grad(torch.sum(a[:, :3] * a[:, :3]), x)
    assert got.abs().max() > 0
    assert_close(got[:, :3], want[:, :3])
    assert_close(got[:, 3], want[:, 3])


@pytest.mark.parametrize("order", [3, 2])
def test_spectral_accel_grids_vjp_matches_jax(order):
    """``spectral_accel_grids``' VJP (autograd through ``torch.fft``) by the
    mass grid and σ against ``jax.vjp`` of the JAX function
    (``nbody3d_tpu/ops/ewald.py:160``), a random cotangent: rtol 1e-4, atol
    1e-5 of the scale; σ̄ rel 1e-3."""
    m, sigma = 16, 1.5 * L / 16
    rng = np.random.default_rng(8)
    rho = rng.uniform(0, 2, (m, m, m)).astype(np.float32)
    cot = rng.standard_normal((3, m**3)).astype(np.float32)
    _, vjp = jax.vjp(lambda r, s: jewald.spectral_accel_grids(r, jnp.float32(L), s, order=order),
                     jnp.asarray(rho), jnp.float32(sigma))
    want_rho, want_sig = vjp(jnp.asarray(cot))
    r_, s_ = t(rho).requires_grad_(), torch.tensor(sigma, requires_grad=True)
    out = ewald.spectral_accel_grids(r_, torch.tensor(L), s_, order=order)
    got_rho, got_sig = torch.autograd.grad(out, (r_, s_), t(cot))
    assert_close(got_rho, want_rho)
    assert float(got_sig) == pytest.approx(float(want_sig), rel=1e-3)


# ------------------------------------------------------- rollout gradients
N, N_REAL, DT, G = 512, 500, 2e-4, 2e-3


def _rollout_inputs():
    pm_np = box_scene(N_REAL, N, seed=4)
    vel = np.zeros_like(pm_np)
    vel[:N_REAL, :3] = np.random.default_rng(4).normal(scale=0.3, size=(N_REAL, 3))
    return pm_np, vel.astype(np.float32)


def _cfg(method, interlace):
    return dict(method=method, pm_grid=16, p3m_nbr_k=4, boundary="periodic", box_size=L, mesh_interlace=interlace)


def _loss(pos_mass, vel):
    return (pos_mass[:N_REAL, :3] ** 2).sum() / N_REAL + (vel[:N_REAL, :3] ** 2).sum()


@functools.lru_cache(maxsize=None)
def _jax_rollout_grads(method, interlace):
    """``jax.grad`` of a 3-step rollout's loss through the JAX step (jnp
    backend) by v0, dt and G (tests/test_periodic.py:180's gradient, through
    ``make_step_fn``)."""
    pm_np, vel = _rollout_inputs()
    step = jax_make_step_fn(JaxConfig(backend="jnp", **_cfg(method, interlace)), N, N_REAL)

    def loss(v, dt, g):
        s = JaxState(jnp.asarray(pm_np), v, jnp.zeros((N, 4), jnp.float32), jnp.asarray(0, jnp.int32))
        out, _ = jax.lax.scan(lambda c, _: (step(c, dt, g), None), s, None, length=3)
        return _loss(out.pos_mass, out.vel)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(vel), jnp.float32(DT), jnp.float32(G))
    return tuple(np.asarray(x) for x in grads)


@pytest.mark.parametrize("method,interlace,backend", [("p3m", False, "auto"), ("p3m", False, "jnp"),
                                                      ("p3m", True, "auto"), ("pm", False, "auto"),
                                                      ("pm", False, "jnp")])
def test_periodic_rollout_grad_matches_jax(method, interlace, backend):
    """A 3-step periodic rollout through ``make_step_fn`` (the kernel route:
    the twins and the periodic VJPs on CPU tensors; ``"jnp"``: autograd
    through the twins) by v0, dt and G against ``jax.grad`` through the JAX
    step: 500 bodies in 512 rows, box 1, grid 16, P3M k = 4.  rtol 2e-3,
    v0's atol 1e-6 of the scale (``test_rollout_grad_matches_jax``'s bound);
    no kernel launches."""
    want = _jax_rollout_grads(method, interlace)
    pm_np, vel = _rollout_inputs()
    step = make_step_fn(SimConfig(backend=backend, **_cfg(method, interlace)), N, N_REAL, "cpu")
    reset_launch_counts()
    v, dt, g = t(vel).requires_grad_(), torch.tensor(DT, requires_grad=True), torch.tensor(G, requires_grad=True)
    s = SimState(t(pm_np), v, torch.zeros((N, 4)), 0)
    for _ in range(3):
        s = step(s, dt, g)
    got = torch.autograd.grad(_loss(s.pos_mass, s.vel), (v, dt, g))
    assert torch.isfinite(got[0]).all() and float(got[0].abs().max()) > 0
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-3, atol=1e-6 * np.abs(want[0]).max())
    np.testing.assert_allclose([float(got[1]), float(got[2])], [float(want[1]), float(want[2])], rtol=2e-3)
    assert all(c == 0 for c in launch_counts().values())


@pytest.mark.parametrize("method", ["p3m", "pm"])
def test_periodic_simulation_step_backward(method):
    """A backward through two steps of ``Simulation``'s periodic step (the
    uniform-box preset, box 10, grid 16) by the velocities: finite, nonzero,
    and the kernel route's gradient equals the ``backend="jnp"`` route's
    (rtol 2e-3, atol 1e-6 of the scale)."""
    grads = []
    for backend in ("auto", "jnp"):
        cfg = SimConfig(method=method, boundary="periodic", box_size=10.0, pm_grid=16, backend=backend)
        sim = Simulation.from_preset("uniform-box", cfg, n=256, box_size=10.0, device="cpu")
        st = sim.state
        vel = st.vel.clone().requires_grad_()
        out = SimState(st.pos_mass, vel, st.accel, 0)
        for _ in range(2):  # the second step's force depends on vel
            out = sim._step_fn(out, sim.dt, sim.G)
        grads.append(torch.autograd.grad(out.pos_mass.sum() + out.vel.sum(), vel)[0])
    gv, rv = grads
    assert torch.isfinite(gv).all() and float(gv.abs().max()) > 0
    np.testing.assert_allclose(gv.numpy(), rv.numpy(), rtol=2e-3, atol=1e-6 * float(rv.abs().max()))
