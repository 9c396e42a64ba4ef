"""Gradients of the port: the force VJP's plain twins (what the kernel
wrappers run on CPU tensors) and autograd through ``make_step_fn``,
against the JAX package's VJP kernels in interpret mode and ``jax.grad``
through its Pallas step.

Tolerances are the JAX package's own (``tests/test_grad.py``): the closed
form against autodiff rtol 1e-4 / atol 1e-6; the full-grid kernel against
autodiff rtol 1e-4 / atol 1e-5 of scale, Ḡ rtol 1e-5; the Newton-3
schedule against the full grid rtol 1e-5 / atol 1e-6 of scale; rollout
gradients rtol 2e-3.  Both sides are f32 with sums in different orders."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.ops.force_jnp import accel_direct as jax_accel_direct  # noqa: E402
from nbody3d_tpu.ops.force_vjp import force_vjp_pallas, force_vjp_reference as jax_reference  # noqa: E402
from nbody3d_tpu.ops.force_vjp import force_vjp_sym_pallas  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import SimState as JaxState  # noqa: E402
from nbody3d_tpu_torch import pair_checks  # noqa: E402
from nbody3d_tpu_torch.config import SimConfig  # noqa: E402
from nbody3d_tpu_torch.ops import force_vjp as fv  # noqa: E402
from nbody3d_tpu_torch.ops.force_torch import accel_direct  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

G, EPS2, DT = 1e-4, 1e-4, 1e-2


def pm_abar(rng, n, n_real=None, heavy=False):
    """Bodies and a cotangent as in tests/test_grad.py; padded rows (from
    ``n_real`` on) carry mass 0 at the origin and a zero cotangent."""
    pm = np.concatenate([rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)
    abar = rng.standard_normal((n, 4)).astype(np.float32)
    abar[:, 3] = 0.0
    if heavy:
        pm[0, 3] = 1e5  # stresses the self mask
    if n_real is not None:
        pm[n_real:] = 0.0
        abar[n_real:] = 0.0
    return pm, abar


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_pm_bar(got, want, rtol, atol_scale):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max())


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("against", ["jax_reference", "torch_autograd"])
def test_vjp_reference(rng, against):
    pm, abar = pm_abar(rng, 96)
    got, g_got = fv.force_vjp_reference(t(pm), G, t(abar), EPS2)
    if against == "jax_reference":
        want, g_want = jax_reference(jnp.asarray(pm), G, jnp.asarray(abar), eps2=EPS2)
    else:
        p = t(pm).requires_grad_()
        out = accel_direct(p, G, eps2=EPS2)
        want = torch.autograd.grad(out, p, t(abar))[0].numpy()
        g_want = float(torch.sum(t(abar) * out.detach()) / G)  # dL/dG = A.a / G
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(g_got), float(g_want), rtol=1e-5)


# ------------------------------------------------------------------ (b)
# (n, n_real): within one of the kernel's 256-row blocks, full and padded;
# and n not a multiple of 256, padded, a shape at which the kernel's second
# block and last source tile end short.  On CPU tensors the wrapper runs the
# twin; the kernel's layout at such shapes is checked on the card
# (chip_smoke.py's _full_checks).
@pytest.mark.parametrize(
    "n,n_real",
    [pytest.param(128, 128, id="128"), pytest.param(128, 100, id="100"), pytest.param(288, 270, id="288-270")],
)
def test_full_grid_twin_matches_pallas(rng, n, n_real):
    pm, abar = pm_abar(rng, n, n_real)
    got, g_got = fv.force_vjp(t(pm), G, t(abar), eps2=EPS2)
    want, g_want = force_vjp_pallas(jnp.asarray(pm), G, jnp.asarray(abar), eps2=EPS2, block=32, interpret=True)
    _, vjp = jax.vjp(lambda p: jax_accel_direct(p, G, eps2=EPS2), jnp.asarray(pm))
    (ad,) = vjp(jnp.asarray(abar))
    assert_pm_bar(got, want, 1e-4, 1e-5)
    assert_pm_bar(got, ad, 1e-4, 1e-5)
    np.testing.assert_allclose(float(g_got), float(g_want), rtol=1e-5)
    assert got.dtype == torch.float32 and g_got.shape == ()


# More shapes with n not a multiple of 256 and padded rows (the kernel's
# layout there is checked on the card, chip_smoke.py's _full_checks), the
# twin against the JAX package's closed form and autodiff, with the test
# above's tolerances; not against the Pallas kernel, whose f32 Ḡ at n = 416
# is 1.4e-5 of |Ḡ| off the f64 closed form, past that rtol of 1e-5.
@pytest.mark.parametrize("n,n_real", [(416, 389), (600, 577)])
def test_full_grid_twin_matches_jax_at_the_layout_edges(rng, n, n_real):
    pm, abar = pm_abar(rng, n, n_real)
    got, g_got = fv.force_vjp(t(pm), G, t(abar), eps2=EPS2)
    want, g_want = jax_reference(jnp.asarray(pm), G, jnp.asarray(abar), eps2=EPS2)
    _, vjp = jax.vjp(lambda p: jax_accel_direct(p, G, eps2=EPS2), jnp.asarray(pm))
    (ad,) = vjp(jnp.asarray(abar))
    assert_pm_bar(got, want, 1e-4, 1e-5)
    assert_pm_bar(got, ad, 1e-4, 1e-5)
    np.testing.assert_allclose(float(g_got), float(g_want), rtol=1e-5)
    assert (got[n_real:, :3] == 0).all()


# ------------------------------------------------------------------ (c)
# (n, tile, n_real): nt = 1 (diagonal only), odd nt, even nt, padded rows.
@pytest.mark.parametrize("n,b,n_real", [(96, 96, 96), (96, 32, 96), (128, 32, 128), (128, 32, 100)])
def test_sym_twins_match_pallas_and_full_grid(rng, n, b, n_real):
    pm, abar = pm_abar(rng, n, n_real, heavy=True)
    acc_d = fv.vjp_sym_diag(t(pm), t(abar), EPS2, b)
    acc_h = fv.vjp_sym_hops(t(pm), t(abar), EPS2, b)
    got, g_got = fv.vjp_combine(acc_d, acc_h, G)
    sym, g_sym = fv.force_vjp_sym(t(pm), G, t(abar), eps2=EPS2, b=b)
    assert torch.equal(got, sym)
    want, g_want = force_vjp_sym_pallas(jnp.asarray(pm), G, jnp.asarray(abar), eps2=EPS2, block=b, interpret=True)
    full, g_full = fv.force_vjp(t(pm), G, t(abar), eps2=EPS2)
    assert_pm_bar(got, want, 1e-5, 1e-6)
    assert_pm_bar(got, full, 1e-5, 1e-6)
    np.testing.assert_allclose(float(g_sym), float(g_want), rtol=1e-5)
    np.testing.assert_allclose(float(g_sym), float(g_full), rtol=1e-5)
    if n == b:
        assert not acc_h.any()  # nt = 1: no hops
    assert (acc_d[:, 5:] == 0).all() and (acc_h[:, 5:] == 0).all()


# ------------------------------------------------------------------ (d)
def _jax_rollout_grad(pm, n, n_real, mode, integrator):
    cfg = JaxConfig(backend="pallas", force_mode=mode, integrator=integrator, block_target=32, block_source=32)
    step = jax_make_step_fn(cfg, n, n_real, platform="cpu")

    def loss(v):
        s = JaxState(jnp.asarray(pm), v, jnp.zeros((n, 4), jnp.float32), jnp.asarray(0, jnp.int32))
        out, _ = jax.lax.scan(lambda c, _: (step(c, jnp.float32(DT), jnp.float32(G)), None), s, None, length=10)
        return jnp.sum(out.pos_mass[0, :3] ** 2)

    return np.asarray(jax.grad(loss)(jnp.zeros((n, 4), jnp.float32)))


def _torch_rollout(step, pm, v, steps=10):
    s = SimState(t(pm.copy()), v, torch.zeros_like(v), 0)
    for _ in range(steps):
        s = step(s, DT, G)
    return s


def _torch_rollout_grad(pm, n, n_real, mode, integrator):
    step = make_step_fn(SimConfig(force_mode=mode, integrator=integrator, block_target=32), n, n_real, "cpu")
    v = torch.zeros((n, 4), requires_grad=True)
    loss = torch.sum(_torch_rollout(step, pm, v).pos_mass[0, :3] ** 2)
    (g,) = torch.autograd.grad(loss, v)
    return g.numpy()


@pytest.mark.parametrize(
    "mode,integrator,n_real", [("sym", "verlet", 64), ("exact", "verlet", 64), ("exact", "yoshida4", 64),
                               ("sym", "verlet", 60)]
)
def test_rollout_grad_matches_jax_pallas_step(rng, mode, integrator, n_real):
    pm, _ = pm_abar(rng, 64, n_real)
    got = _torch_rollout_grad(pm, 64, n_real, mode, integrator)
    want = _jax_rollout_grad(pm, 64, n_real, mode, integrator)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6 * np.abs(want).max())


def _jax_scalar_grads(pm, vel, n, n_real, mode, integrator, k=3):
    cfg = JaxConfig(backend="pallas", force_mode=mode, integrator=integrator, block_target=32, block_source=32)
    step = jax_make_step_fn(cfg, n, n_real, platform="cpu")

    def loss(dt, g):
        s = JaxState(jnp.asarray(pm), jnp.asarray(vel), jnp.zeros((n, 4), jnp.float32), jnp.asarray(0, jnp.int32))
        out, _ = jax.lax.scan(lambda c, _: (step(c, dt, g), None), s, None, length=k)
        return jnp.sum(out.pos_mass[:n_real, :3] ** 2) + jnp.sum(out.vel[:n_real, :3] ** 2)

    return [float(x) for x in jax.grad(loss, argnums=(0, 1))(jnp.float32(DT), jnp.float32(G))]


@pytest.mark.parametrize(
    "mode,integrator,n_real", [("sym", "verlet", 64), ("sym", "verlet", 60), ("exact", "verlet", 60),
                               ("exact", "yoshida4", 64)]
)
def test_rollout_grad_by_dt_and_G_matches_jax_pallas_step(rng, mode, integrator, n_real):
    """The gradient of a 3-step rollout by the scalars dt and G (0-d
    tensors), against jax.grad through the JAX Pallas step (interpret
    mode): rtol 2e-3, the rollout tolerance."""
    n = 64
    pm, _ = pm_abar(rng, n, n_real)
    vel = np.zeros((n, 4), np.float32)
    vel[:n_real, :3] = 0.3 * rng.standard_normal((n_real, 3))
    step = make_step_fn(SimConfig(force_mode=mode, integrator=integrator, block_target=32), n, n_real, "cpu")
    dt = torch.tensor(DT, requires_grad=True)
    g = torch.tensor(G, requires_grad=True)
    s = SimState(t(pm.copy()), t(vel.copy()), torch.zeros((n, 4)), 0)
    for _ in range(3):
        s = step(s, dt, g)
    loss = torch.sum(s.pos_mass[:n_real, :3] ** 2) + torch.sum(s.vel[:n_real, :3] ** 2)
    got = [float(x) for x in torch.autograd.grad(loss, (dt, g))]
    want = _jax_scalar_grads(pm, vel, n, n_real, mode, integrator)
    assert all(np.isfinite(got)) and got[0] != 0 and got[1] != 0
    np.testing.assert_allclose(got, want, rtol=2e-3)


@pytest.mark.parametrize("mode", ["sym", "exact"])
def test_grad_by_G_matches_plain_route(rng, mode):
    """The kernel routes' dt and G gradients against the backend="jnp"
    route's, which autograd takes through the plain oracle."""
    n = 64
    pm, _ = pm_abar(rng, n)
    grads = {}
    for route, cfg in (("plain", SimConfig(backend="jnp")), ("kernels", SimConfig(force_mode=mode, block_target=32))):
        step = make_step_fn(cfg, n, n, "cpu")
        dt, g = torch.tensor(DT, requires_grad=True), torch.tensor(G, requires_grad=True)
        s = SimState(t(pm.copy()), torch.zeros((n, 4)), torch.zeros((n, 4)), 0)
        for _ in range(3):
            s = step(s, dt, g)
        grads[route] = [float(x) for x in torch.autograd.grad(torch.sum(s.pos_mass[:, :3] ** 2), (dt, g))]
    np.testing.assert_allclose(grads["kernels"], grads["plain"], rtol=2e-3)


# ------------------------------------------------------------------ (e)
def _small(rng, mode):
    """tests/test_grad.py's 8-body, 20-step problem on the kernel route."""
    pm = np.concatenate([rng.standard_normal((8, 3)), rng.uniform(10, 50, (8, 1))], axis=1).astype(np.float32)
    step = make_step_fn(SimConfig(force_mode=mode, block_target=4), 8, 8, "cpu")
    target = torch.tensor([1.0, 0.0, 0.0])

    def loss(v0):
        return torch.sum((_torch_rollout(step, pm, v0, steps=20).pos_mass[0, :3] - target) ** 2)

    return loss


@pytest.mark.parametrize("mode", ["sym", "exact"])
def test_grad_matches_finite_difference(rng, mode):
    loss = _small(rng, mode)
    v0 = torch.zeros((8, 4), requires_grad=True)
    (g,) = torch.autograd.grad(loss(v0), v0)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    eps = 1e-3
    with torch.no_grad():
        for idx in [(0, 0), (0, 1), (3, 2)]:
            e = torch.zeros((8, 4))
            e[idx] = 1.0
            fd = (loss(eps * e) - loss(-eps * e)) / (2 * eps)
            np.testing.assert_allclose(float(g[idx]), float(fd), rtol=2e-2, atol=1e-5)


@pytest.mark.parametrize("mode", ["sym", "exact"])
def test_gradient_descent_reaches_target(rng, mode):
    loss = _small(rng, mode)
    v = torch.zeros((8, 4), requires_grad=True)
    l0 = float(loss(v.detach()))
    for _ in range(40):
        (g,) = torch.autograd.grad(loss(v), v)
        with torch.no_grad():
            v -= 2.0 * g
    assert float(loss(v.detach())) < 1e-3 * l0
    assert torch.isfinite(v).all()


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize("grad", [False, "tensors", True, "scalars"])
def test_sym_step_in_place_only_without_grad(rng, grad):
    """Without grad the sym step updates the state in place, with dt and G
    given as Python floats (False) or as 0-d tensors that need no gradient
    ("tensors"); with grad (by the state, True, or by dt and G, "scalars")
    it leaves its inputs alone."""
    pm, _ = pm_abar(rng, 64)
    step = make_step_fn(SimConfig(force_mode="sym", block_target=32), 64, 64, "cpu")
    v = torch.full((64, 4), 0.01)
    v[:, 3] = 0.0
    s = SimState(t(pm.copy()), v.clone().requires_grad_(grad is True), torch.zeros((64, 4)), 0)
    ins = (s.pos_mass, s.vel, s.accel)
    before = [x.detach().clone() for x in ins]
    scalars = (DT, G) if grad in (False, True) else [torch.tensor(x, requires_grad=grad == "scalars") for x in (DT, G)]
    out = step(s, *scalars)
    outs = (out.pos_mass, out.vel, out.accel)
    moved = not torch.equal(out.pos_mass.detach(), before[0])
    assert moved
    if grad in (True, "scalars"):
        assert out.vel.requires_grad and out.pos_mass.requires_grad
        for x, x0 in zip(ins, before):
            assert torch.equal(x.detach(), x0)  # inputs untouched
        assert all(o.data_ptr() != x.data_ptr() for o, x in zip(outs, ins))
    else:
        assert [o.data_ptr() for o in outs] == [x.data_ptr() for x in ins]


@pytest.mark.parametrize("pos_grad", [False, True])
def test_sym_step_force_vjp_only_for_positions(rng, pos_grad, monkeypatch):
    """The force cotangent reaches only pos_mass: with positions that need
    no gradient (a rollout's first step) the backward runs no force VJP,
    and the velocity gradient is the same either way."""
    import nbody3d_tpu_torch.ops.step as step_mod

    calls = []
    real = step_mod.force_vjp_sym
    monkeypatch.setattr(step_mod, "force_vjp_sym", lambda *a, **k: calls.append(1) or real(*a, **k))
    pm, _ = pm_abar(rng, 64)
    step = make_step_fn(SimConfig(force_mode="sym", block_target=32), 64, 64, "cpu")
    p = t(pm).requires_grad_(pos_grad)
    v = torch.zeros((64, 4), requires_grad=True)
    out = step(SimState(p, v, torch.zeros((64, 4)), 0), DT, G)
    loss = torch.sum(out.pos_mass[:, :3] ** 2) + torch.sum(out.vel[:, :3] ** 2)
    grads = torch.autograd.grad(loss, [p, v] if pos_grad else [v])
    assert len(calls) == int(pos_grad)
    a = accel_direct(t(pm), G, eps2=EPS2)[:, :3]
    # From v = 0 and a zero old acceleration: v' = a dt / 2 and
    # x' = x + (v' + a dt / 2) dt = x + a dt^2, so d/dv = 2 x' dt + 2 v'.
    want_v = 2 * (t(pm)[:, :3] + a * DT * DT) * DT + a * DT
    np.testing.assert_allclose(grads[-1][:, :3].numpy(), want_v.numpy(), rtol=1e-4, atol=1e-9)


# ------------------------------------------------------------------ (g)
def test_cpu_runs_launch_nothing_and_wrappers_check(rng):
    reset_launch_counts()
    pm, abar = pm_abar(rng, 64)
    fv.force_vjp(t(pm), G, t(abar), eps2=EPS2)
    fv.force_vjp_sym(t(pm), G, t(abar), eps2=EPS2, b=64)  # nt = 1 is allowed
    _torch_rollout_grad(pm, 64, 64, "sym", "verlet")
    assert all(c == 0 for c in launch_counts().values())
    assert len(launch_counts()) == 19
    with pytest.raises(RuntimeError, match="never take such tensors"):
        fv.force_vjp_sym(t(pm).requires_grad_(), G, t(abar), eps2=EPS2, b=32)
    with pytest.raises(ValueError):
        fv.force_vjp_sym(t(pm), G, t(abar), eps2=EPS2, b=48)  # 48 does not divide 64
    with pytest.raises(ValueError):
        fv.force_vjp(t(pm), G, t(abar[:32]), eps2=EPS2)
    with pytest.raises(ValueError):
        fv.vjp_combine(t(pm), t(pm), G)  # accumulators are (N, 8)
    with pytest.raises(ValueError, match="grad_precision"):
        make_step_fn(SimConfig(grad_precision="bf16"), 64, 64, "cpu")


# ------------------------------------------------------------------ (h)
@pytest.mark.parametrize("b", [128, 256])
def test_sym_twins_with_a_1e7_body_match_pallas(b):
    """``pair_checks.vjp_heavy``: a 1e7 body among bodies of mass 10-50 in
    one tile, padded rows, on which the card holds ``vjp_sym_hops`` to its
    twin; the sym twins through ``force_vjp_sym`` against
    ``force_vjp_sym_pallas`` (interpret mode) and the full-grid twin, the
    bounds of (c)."""
    pm, abar = pair_checks.vjp_heavy(n=1024, b=b)
    got, g_got = fv.force_vjp_sym(t(pm), G, t(abar), eps2=EPS2, b=b)
    want, g_want = force_vjp_sym_pallas(jnp.asarray(pm), G, jnp.asarray(abar), eps2=EPS2, block=b, interpret=True)
    full, g_full = fv.force_vjp(t(pm), G, t(abar), eps2=EPS2)
    assert_pm_bar(got, want, 1e-5, 1e-6)
    assert_pm_bar(got, full, 1e-5, 1e-6)
    np.testing.assert_allclose(float(g_got), float(g_want), rtol=1e-5)
    np.testing.assert_allclose(float(g_got), float(g_full), rtol=1e-5)
    assert not got[1000:, :3].any()


def test_pair_phi_sum_is_minus_w_dg():
    """``csrc/pair.cuh``'s ``VjpPair::phi``, which ``vjp_sym_hops`` adds in
    place of ``phi_t + phi_s``: the identity ``w m_j (d.A_k) - w m_k (d.A_j)
    = -w (d.g)``, ``g = m_k A_j - m_j A_k``, in f64 on random pairs through
    the twins' ``_pair_terms`` with their w, to 1e-14 of the products'
    size w |d| (m_k |A_j| + m_j |A_k|) before the dot products cancel."""
    rng = np.random.default_rng(11)
    n = 4096
    xk, xj = (torch.from_numpy(np.c_[rng.standard_normal((n, 3)), rng.uniform(1, 1e7, (n, 1))]) for _ in range(2))
    ak, aj = (torch.from_numpy(rng.standard_normal((n, 3))) for _ in range(2))
    _, _, _, phi_t, phi_s = fv._pair_terms(xk, ak, xj, aj, EPS2)
    d = xj[:, :3] - xk[:, :3]
    r = torch.rsqrt(d[:, 0] * d[:, 0] + (d[:, 1] * d[:, 1] + (d[:, 2] * d[:, 2] + EPS2)))
    w = r * r * r  # the twins' w, bit for bit
    g = xk[:, 3:] * aj - xj[:, 3:] * ak
    folded = -w * torch.sum(d * g, dim=1)
    # The size of the products before the dot products cancel.
    norm = functools.partial(torch.linalg.norm, dim=1)
    size = w * norm(d) * (xk[:, 3] * norm(aj) + xj[:, 3] * norm(ak))
    assert phi_t.dtype == torch.float64
    assert ((phi_t + phi_s - folded).abs() <= 1e-14 * size).all()
