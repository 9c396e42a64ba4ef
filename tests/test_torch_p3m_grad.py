"""Gradients of the mesh solvers (``method="p3m"`` and ``"pm"``) against the
JAX package on the CPU: the short-range backward twin (what the
``short_range_bwd`` wrapper runs on CPU tensors) against the Pallas
backward in interpret mode and ``jax.vjp`` of the jnp form; the mesh legs'
VJPs (``mesh_cuda.deposit_vjp``/``gather_vjp``) against ``jax.vjp`` of the
JAX package's XLA forms; ``accel_p3m``/``accel_pm`` gradients and 3-step
rollout gradients through ``make_step_fn`` against ``jax.grad`` of the JAX
functions (``backend="jnp"``).

Inputs are a cut of the JAX P3M tests' clustered scene: the two-galaxy
preset at n = 2,048 (two 1e7 centres among them), zero-padded to 4,096
rows, made with numpy.  The selection is flat, where the port's mutual
mask equals the JAX package's, so the gather-only backward is the exact
VJP on both sides.
Bounds are the JAX tests' (``tests/test_p3m.py:397, 455``): position and
mass cotangents rtol 1e-4 with atol 1e-5 of the scale, σ's rel 1e-3, a
rollout's gradients rtol 2e-3.  Both sides are f32 with sums in different
orders; the twin takes the exact erfc, the Pallas kernel the
Abramowitz-Stegun one (|err| <= 1.5e-7)."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
import nbody3d_tpu.ops.pm as jpm  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.models.registry import make_preset  # noqa: E402
from nbody3d_tpu.ops.mesh_pallas import mesh_accel_jnp  # noqa: E402
from nbody3d_tpu.ops.morton import morton_keys as jax_morton_keys  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import SimState as JaxState  # noqa: E402
from nbody3d_tpu_torch import SimConfig  # noqa: E402
from nbody3d_tpu_torch.ops import mesh_cuda as mc  # noqa: E402
from nbody3d_tpu_torch.ops import p3m, pm  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

G, EPS2, DT = 1e-4, 1e-4, 1e-3
GRID = 32


def clustered(n=4096, n_pad=8192):
    pos_mass, vel, _ = make_preset("two-galaxy", seed=0, G=G, n=n)
    n_real = pos_mass.shape[0]
    pad = ((0, n_pad - n_real), (0, 0))
    return np.pad(pos_mass, pad).astype(np.float32), np.pad(vel, pad).astype(np.float32), n_real


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close(got, want, rtol=1e-4, atol_scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max())


@pytest.fixture(scope="module")
def scene():
    return clustered(2048, 4096)


# ------------------------------------------------------ short-range backward
def sorted_inputs(pm_np, n_real, block, nbr_k, zero_tile=None):
    """JAX's sorted rows, σ, rcut, lists and mutual mask.  ``zero_tile``
    zeroes one real tile's masses and kills every pair (t, j) with
    ``(t + j) % 5 == 0``, t != j, on both sides: the mask stays mutual."""
    jpm_ = jnp.asarray(pm_np)
    _, h = jpm._box(jpm_[:n_real, :3], GRID)
    jps = jpm_[jnp.argsort(jax_morton_keys(jpm_, n_real), stable=True)]
    if zero_tile is not None:
        jps = jps.at[zero_tile * block : (zero_tile + 1) * block, 3].set(0.0)
    lo_b, hi_b = jp3m._sorted_aabbs(jps, n_real, block)
    nb = pm_np.shape[0] // block
    kth, neg, idx = jax.jit(lambda a, b, c: jp3m._select_neighbors(a, b, 0, nb, c, nbr_k))(lo_b, hi_b, h)
    mask = np.array(jp3m.mutual_neighbor_mask(neg, idx, kth))
    if zero_tile is not None:
        idx_np, rows = np.asarray(idx), np.arange(nb)[:, None]
        mask[((rows + idx_np) % 5 == 0) & (idx_np != rows)] = 0.0
    sigma = jp3m.DEFAULT_SIGMA_CELLS * h
    return jps, idx, jnp.asarray(mask), sigma, jp3m.DEFAULT_RCUT_SIGMAS * sigma


@pytest.mark.parametrize("block,zero_tile", [(128, None), (256, 3)])
def test_short_range_bwd_twin_matches_jax(scene, block, zero_tile):
    """The twin against ``_short_range_tiles_bwd_pallas`` (interpret) and
    ``jax.vjp`` of ``_short_range_tiles`` for a random cotangent, by the
    sorted rows (positions and mass) and σ; ``_ShortRange``'s backward is
    the twin.  With a zero-mass tile and masked slots, that tile's rows
    still get a mass cotangent (the forward skips such a source tile, its
    backward must not)."""
    pm_np, _, n_real = scene
    jps, idx, mask, sigma, rcut = sorted_inputs(pm_np, n_real, block, 8, zero_tile)
    nb = pm_np.shape[0] // block
    g = np.random.default_rng(1).standard_normal((pm_np.shape[0], 4)).astype(np.float32)
    g[:, 3] = 0.0
    pal, pal_sig = jp3m._short_range_tiles_bwd_pallas(jps, jnp.asarray(g[:, :3]), idx, nb, EPS2, sigma, rcut, block,
                                                      mask, interpret=True)
    _, vjp = jax.vjp(lambda p, s: jp3m._short_range_tiles(p, idx, 0, nb, EPS2, s, rcut, block, nbr_mask=mask),
                     jps, sigma)
    ad, ad_sig = vjp(jnp.asarray(g[:, :3]))

    tps, tidx, tmask = t(jps), torch.from_numpy(np.array(idx)), t(mask)
    tsig, trcut = torch.tensor(float(sigma)), torch.tensor(float(rcut))
    got, got_sig = p3m.short_range_tiles_bwd(tps, t(g), tidx, EPS2, tsig, trcut, block, tmask)
    for want, want_sig in ((pal, pal_sig), (ad, ad_sig)):
        want = np.asarray(want)
        assert_close(got[:, :3], want[:, :3])
        assert_close(got[:, 3], want[:, 3])
        assert float(got_sig) == pytest.approx(float(want_sig), rel=1e-3)

    ps_, sig_ = tps.clone().requires_grad_(), tsig.clone().requires_grad_()
    out = p3m._ShortRange.apply(ps_, sig_, trcut, tidx, tmask, EPS2, block, "auto")
    auto, auto_sig = torch.autograd.grad(out, (ps_, sig_), t(g))
    assert torch.equal(auto, got) and torch.equal(auto_sig, got_sig)
    if zero_tile is not None:
        rows = slice(zero_tile * block, (zero_tile + 1) * block)
        assert (tmask == 0).any() and not tps[rows, 3].any() and got[rows, 3].abs().max() > 0


@pytest.mark.parametrize("nbr_k", [32, 8])
def test_short_range_bwd_is_exact_vjp_under_two_level_selection(monkeypatch, nbr_k):
    """The two-level selection (``_FLAT_MAX_TILES`` patched to 4) at an odd
    tile count: 157 tiles of 16 rows (n = 2,500 two-galaxy bodies padded to
    2,512), so its supers are single tiles and rows run short of admitted
    candidates, as at 8,193 tiles for two-galaxy 2M.  The port's mask kills
    the non-admitted slots and stays symmetric, so the backward twin's
    gather is the exact VJP: it matches autograd through the forward twin
    (x̄, m̄ rtol 1e-4 with atol 1e-5 of the scale, σ̄ rel 1e-3).  No tile is
    massless, so the forward twin, which skips massless source tiles, leaves
    no slot out that the backward counts."""
    monkeypatch.setattr(p3m, "_FLAT_MAX_TILES", 4)
    block = 16
    pm_np, _, n_real = clustered(2500, 157 * block)
    tpm = t(pm_np)
    _, h = pm._box(tpm[:n_real, :3], GRID)
    ps = tpm[torch.argsort(p3m.morton_keys(tpm, n_real), stable=True)]
    lo, hi = p3m._sorted_aabbs(ps, n_real, block)
    kth, neg, idx = p3m._select_neighbors(lo, hi, h, nbr_k)
    mask = p3m.mutual_neighbor_mask(neg, idx, kth)
    assert (-neg == p3m._NOT_ADMITTED).any() and (mask == 0).any()
    nb = 157
    keep = np.zeros((nb, nb), bool)
    live = mask.numpy() > 0
    keep[np.nonzero(live)[0], idx.numpy()[live]] = True
    assert not (keep & ~keep.T).any()
    assert (ps.view(nb, block, 4)[:, :, 3].sum(dim=1) > 0).all()

    sigma = p3m.DEFAULT_SIGMA_CELLS * h
    rcut = p3m.DEFAULT_RCUT_SIGMAS * sigma
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((ps.shape[0], 4)).astype(np.float32))
    g[:, 3] = 0.0
    ps_, sig_ = ps.clone().requires_grad_(), sigma.clone().requires_grad_()
    out = p3m._short_range_tiles(ps_, idx, EPS2, sig_, rcut, block, mask)
    auto, auto_sig = torch.autograd.grad(out, (ps_, sig_), g)
    got, got_sig = p3m.short_range_tiles_bwd(ps, g, idx, EPS2, sigma, rcut, block, mask)
    assert got[:, :3].abs().max() > 0 and got[:, 3].abs().max() > 0
    assert_close(got[:, :3], auto[:, :3])
    assert_close(got[:, 3], auto[:, 3])
    assert float(got_sig) == pytest.approx(float(auto_sig), rel=1e-3)


# ---------------------------------------------------------------- mesh VJPs
def cells(order):
    return (p3m._tsc_cells, jp3m._tsc_cells) if order == 3 else (pm._cic_cells, jpm._cic_cells)


def port_leg(part, order, pos, mass, lo, h, sigma, grids):
    """The port's deposit, gather or whole mesh leg (deposit, FFT solve,
    gather) through the differentiable wrappers."""
    c, f = cells(order)[0](pos, lo, h, GRID)
    c4, fm = mc.mesh_operands(c, f, mass)
    if part == "deposit":
        return mc.deposit_diff(c4, fm, GRID, order)
    if part == "leg":
        grids = p3m.solve_accel_long(mc.deposit_diff(c4, fm, GRID, order), h, EPS2, sigma, order=order)
    return mc.gather_diff(grids, c4, fm, GRID, order)[:, :3]


def jax_leg(part, order, pos, mass, lo, h, sigma, grids):
    if part == "leg":
        return mesh_accel_jnp(jnp.concatenate([pos, mass[:, None]], 1), lo, h, sigma, grid=GRID, eps2=EPS2,
                              order=order)
    if order == 3:
        if part == "deposit":
            return jp3m.tsc_deposit(pos, mass, lo, h, GRID)
        c, w, _ = jp3m._tsc_cells(pos, lo, h, GRID)
        return jp3m.tsc_gather(grids, c, w, GRID)
    if part == "deposit":
        return jpm.cic_deposit(pos, mass, lo, h, GRID)
    return jpm.cic_gather(grids, *jpm._cic_cells(pos, lo, h, GRID), GRID)


@pytest.mark.parametrize("order,part", [(3, "deposit"), (3, "gather"), (3, "leg"), (2, "deposit"), (2, "gather")])
def test_mesh_vjp_matches_jax(scene, order, part):
    """``deposit_diff``, ``gather_diff`` and P3M's whole mesh leg against
    ``jax.vjp`` of the JAX forms (``tsc_``/``cic_deposit``,
    ``tsc_``/``cic_gather``, ``mesh_accel_jnp``) for a random cotangent: by
    positions, mass, the box ``lo`` and ``h``, σ and the grids.  The box's
    and σ's sums cancel over many bodies: rel 1e-3, as σ's in the JAX
    tests.  (PM's leg is ``test_accel_grad_matches_jax``'s.)"""
    pm_np, _, n_real = scene
    rng = np.random.default_rng(2)
    pos, mass = pm_np[:, :3], pm_np[:, 3].copy()
    mass[mass > 1e6] = 0.0  # the heavy split's mesh mass
    _, h = jpm._box(jnp.asarray(pos[:n_real]), GRID)
    lo = np.asarray(jpm._box(jnp.asarray(pos[:n_real]), GRID)[0])
    h, sigma = float(h), float(jp3m.DEFAULT_SIGMA_CELLS * h)
    grids = rng.standard_normal((3, GRID**3)).astype(np.float32)
    out_shape = (GRID, GRID, GRID) if part == "deposit" else (pm_np.shape[0], 3)
    cot = rng.standard_normal(out_shape).astype(np.float32)
    args = (pos, mass, lo, np.float32(h), np.float32(sigma), grids)

    # Jitted: eager JAX compiles each of the many small ops on first use.
    want_out, vjp = jax.vjp(jax.jit(functools.partial(jax_leg, part, order)), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(cot))
    targs = [t(a).requires_grad_() for a in args]
    got_out = port_leg(part, order, *targs)
    assert_close(got_out.detach(), want_out)
    got = torch.autograd.grad(got_out, targs, t(cot), allow_unused=True)
    for name, g, w in zip(("pos", "mass", "lo", "h", "sigma", "grids"), got, want):
        w = np.asarray(w)
        if not np.abs(w).max():  # sigma outside the leg, the grids outside the gather
            assert g is None or not g.any(), name
        elif w.ndim == 0 or name == "lo":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, err_msg=name)
        else:
            assert_close(g, w)


# ---------------------------------------------------------- accel gradients
@pytest.fixture(scope="module")
def accel_grads(scene):
    """``jax.grad`` of ``sum(W * accel)`` by pos_mass and G for both
    methods (jnp short range and mesh), grid 32, P3M k = 8, tile 256."""
    pm_np, _, n_real = scene
    w = np.random.default_rng(3).standard_normal((pm_np.shape[0], 4)).astype(np.float32)
    w[n_real:] = 0.0
    kw = {"p3m": dict(grid=GRID, eps2=EPS2, n_real=n_real, nbr_k=8, block=256),
          "pm": dict(grid=GRID, eps2=EPS2, n_real=n_real)}
    out = {}
    for method, fn, extra in (("p3m", jp3m.accel_p3m, dict(short_backend="jnp", mesh_backend="jnp")),
                              ("pm", jpm.accel_pm, dict(mesh_backend="jnp"))):
        def loss(p, g, fn=fn, kw=kw[method], extra=extra):
            return jnp.sum(jnp.asarray(w) * fn(p, g, **kw, **extra))
        out[method] = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(jnp.asarray(pm_np), jnp.float32(G))]
    return w, kw, out


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("method", ["p3m", "pm"])
def test_accel_grad_matches_jax(scene, accel_grads, method, backend):
    """The gradient of a fixed random-weight loss of ``accel_p3m`` /
    ``accel_pm`` by pos_mass (positions and masses) and G, on the kernel
    route (the twins and the mesh VJPs on CPU tensors) and on
    ``backend="jnp"`` (autograd through the mesh twins): rtol 1e-4, atol
    1e-5 of the scale; G's rel 1e-4."""
    pm_np, _, _ = scene
    w, kw, want = accel_grads
    p, g = t(pm_np).requires_grad_(), torch.tensor(G, requires_grad=True)
    if method == "p3m":
        acc = p3m.accel_p3m(p, g, backend=backend, **kw[method])
    else:
        acc = pm.accel_pm(p, g, mesh_backend=backend, **kw[method])
    got_p, got_g = torch.autograd.grad(torch.sum(t(w) * acc), (p, g))
    assert_close(got_p[:, :3], want[method][0][:, :3])
    assert_close(got_p[:, 3], want[method][0][:, 3])
    assert float(got_g) == pytest.approx(float(want[method][1]), rel=1e-4)


# --------------------------------------------------------- rollout gradients
def _jax_rollout_grads(cfg, pm_np, vel, n_real, k):
    n = pm_np.shape[0]
    step = jax_make_step_fn(JaxConfig(backend="jnp", **cfg), n, n_real)

    def loss(v, dt, g):
        s = JaxState(jnp.asarray(pm_np), v, jnp.zeros((n, 4), jnp.float32), jnp.asarray(0, jnp.int32))
        out, _ = jax.lax.scan(lambda c, _: (step(c, dt, g), None), s, None, length=k)
        return jnp.sum(out.pos_mass[:n_real, :3] ** 2) / n_real + jnp.sum(out.vel[:n_real, :3] ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(vel), jnp.float32(DT), jnp.float32(G))
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("method", ["p3m", "pm"])
def test_rollout_grad_matches_jax(method):
    """A 3-step rollout through ``make_step_fn`` (kernel route, CPU) by v0,
    dt and G against ``jax.grad`` through the JAX step (jnp backend):
    two-galaxy n = 2,000 in 2,048 rows, grid 32; P3M 8 tiles of 256 with
    k = 4 (flat selection).  rtol 2e-3, v0's atol 1e-6 of the scale."""
    pm_np, vel, n_real = clustered(2000, 2048)
    cfg = dict(method=method, pm_grid=GRID, p3m_nbr_k=4)
    want = _jax_rollout_grads(cfg, pm_np, vel, n_real, 3)
    step = make_step_fn(SimConfig(**cfg), 2048, n_real, "cpu")
    v, dt, g = t(vel).requires_grad_(), torch.tensor(DT, requires_grad=True), torch.tensor(G, requires_grad=True)
    s = SimState(t(pm_np), v, torch.zeros((2048, 4)), 0)
    for _ in range(3):
        s = step(s, dt, g)
    loss = torch.sum(s.pos_mass[:n_real, :3] ** 2) / n_real + torch.sum(s.vel[:n_real, :3] ** 2)
    got = torch.autograd.grad(loss, (v, dt, g))
    assert torch.isfinite(got[0]).all() and float(got[0].abs().max()) > 0
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-3, atol=1e-6 * np.abs(want[0]).max())
    np.testing.assert_allclose([float(got[1]), float(got[2])], [float(want[1]), float(want[2])], rtol=2e-3)


# ------------------------------------------------------------------ no graph
@pytest.mark.parametrize("method", ["p3m", "pm"])
def test_mesh_step_builds_graph_only_for_grad(method):
    """Without anything that needs a gradient, or under ``no_grad``, a mesh
    step builds no graph; with a velocity that needs one, it does, and no
    kernel launches on CPU tensors."""
    pm_np, vel, n_real = clustered(1000, 1024)
    step = make_step_fn(SimConfig(method=method, pm_grid=GRID), 1024, n_real, "cpu")
    reset_launch_counts()
    plain = step(SimState(t(pm_np), t(vel), torch.zeros((1024, 4)), 0), DT, G)
    v = t(vel).requires_grad_()
    with torch.no_grad():
        frozen = step(SimState(t(pm_np), v, torch.zeros((1024, 4)), 0), DT, G)
    graph = step(step(SimState(t(pm_np), v, torch.zeros((1024, 4)), 0), DT, G), DT, G)
    for s in (plain, frozen):
        assert all(x.grad_fn is None and not x.requires_grad for x in (s.pos_mass, s.vel, s.accel))
    assert all(x.grad_fn is not None for x in (graph.pos_mass, graph.vel, graph.accel))
    torch.testing.assert_close(frozen.pos_mass, plain.pos_mass, rtol=0, atol=0)
    (gv,) = torch.autograd.grad(torch.sum(graph.pos_mass[:, :3] ** 2), v)
    assert torch.isfinite(gv).all() and gv.abs().max() > 0
    assert all(c == 0 for c in launch_counts().values())


def test_short_range_bwd_wrapper_checks():
    """The backward wrapper refuses tensors that require grad and tiles that
    do not make N, as the forward's does."""
    ps = torch.zeros((512, 4))
    ids, mask = torch.zeros((2, 2), dtype=torch.int64), torch.ones((2, 2))
    one = torch.tensor(1.0)
    with pytest.raises(RuntimeError, match="never take such tensors"):
        p3m.short_range_tiles_bwd(ps.requires_grad_(), torch.zeros((512, 4)), ids, EPS2, one, one, 256, mask)
    with pytest.raises(ValueError, match="do not make N"):
        p3m.short_range_tiles_bwd(torch.zeros((512, 4)), torch.zeros((512, 4)), ids, EPS2, one, one, 128, mask)
