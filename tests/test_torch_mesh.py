"""The mesh kernels' plain twins (``ops/mesh_cuda.py``: what the
``mesh_deposit`` and ``mesh_gather`` wrappers run on CPU tensors) and the
PM solver (``ops/pm.py``) against the JAX package.

Inputs are the JAX P3M tests' clustered scene (``tests/test_p3m.py``):
the two-galaxy preset at n = 4,096 (two 1e7 centres among them), zero-padded
to 8,192 rows.  The JAX side of the twins is the tile kernels in
interpret mode plus their XLA repair (``deposit_tiles``/``gather_tiles``
+ ``repair_*``) and the XLA forms (``tsc_deposit``/``cic_deposit``,
``tsc_gather``/``cic_gather``).  Bounds: the deposit and gather within
1e-5 of the grid's (output's) max, the total mass to 1e-6; the PM
accelerations within rtol 1e-4 and atol 1e-5 of the max.  Both sides are
f32 and add in different orders."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.mesh_pallas as jmp  # noqa: E402
import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
import nbody3d_tpu.ops.pm as jpm  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.models.registry import make_preset  # noqa: E402
from nbody3d_tpu.ops.morton import morton_keys as jax_morton_keys  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import init_state as jax_init_state  # noqa: E402
from nbody3d_tpu_torch import SimConfig, scatter_checks  # noqa: E402
from nbody3d_tpu_torch.ops import mesh_cuda as mc  # noqa: E402
from nbody3d_tpu_torch.ops import p3m, pm  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

G, EPS2 = 1e-4, 1e-4


def clustered(n=4096, n_pad=8192):
    pos_mass, vel, _ = make_preset("two-galaxy", seed=0, G=G, n=n)
    n_real = pos_mass.shape[0]
    pad = ((0, n_pad - n_real), (0, 0))
    return np.pad(pos_mass, pad).astype(np.float32), np.pad(vel, pad).astype(np.float32), n_real


@pytest.fixture(scope="module")
def scene():
    """The clustered scene Morton-sorted as ``accel_p3m`` sorts it (JAX
    keys), with its grid-32 box."""
    pm_np, _, n_real = clustered()
    jps = jnp.asarray(pm_np)[jnp.argsort(jax_morton_keys(jnp.asarray(pm_np), n_real), stable=True)]
    return np.asarray(jps), n_real


def cells(ps_np, n_real, grid, order):
    """``(jax (c, w, f), torch (c4, fm), jax box)`` of the sorted scene."""
    jps = jnp.asarray(ps_np)
    lo, h = jpm._box(jps[:n_real, :3], grid)
    if order == 3:
        c, w, f = jp3m._tsc_cells(jps[:, :3], lo, h, grid)
    else:
        c, f = jpm._cic_cells(jps[:, :3], lo, h, grid)
        w = jnp.stack([1.0 - f, f], axis=0)
    tps = torch.from_numpy(ps_np.copy())
    tlo, th = pm._box(tps[:n_real, :3], grid)
    tc, tf = (p3m._tsc_cells if order == 3 else pm._cic_cells)(tps[:, :3], tlo, th, grid)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(f))
    return (c, w, f), mc.mesh_operands(tc, tf, tps[:, 3]), (lo, h)


CASES = [(3, 128), (3, 256), (2, 128), (2, 256)]


@pytest.mark.parametrize("order,block", CASES)
def test_deposit_twin_matches_jax_tile_kernel(scene, order, block):
    ps_np, n_real = scene
    grid = 32
    (c, w, f), (c4, fm), (lo, h) = cells(ps_np, n_real, grid, order)
    mass = jnp.asarray(ps_np[:, 3])
    corners, valid, dirty = jmp.tile_corners(c, block, grid, order=order)
    nt = ps_np.shape[0] // block
    rho = jmp.deposit_tiles(c, f, mass, corners, grid, block, order=order, interpret=True)
    rho = np.asarray(jmp.repair_deposit(rho, c, w, mass, valid, dirty, nt, grid, block, order=order))
    xla = np.asarray((jp3m.tsc_deposit if order == 3 else jpm.cic_deposit)(
        jnp.asarray(ps_np[:, :3]), mass, lo, h, grid))
    got = mc.deposit(c4, fm, grid, order).numpy()
    for want in (rho, xla):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.sum(dtype=np.float64), want.sum(dtype=np.float64), rtol=1e-6)


@pytest.mark.parametrize("order,block", CASES)
def test_gather_twin_matches_jax_tile_kernel(scene, order, block):
    ps_np, n_real = scene
    grid = 32
    (c, w, f), (c4, fm), _ = cells(ps_np, n_real, grid, order)
    grids_np = np.random.default_rng(order * 1000 + block).standard_normal((3, grid**3)).astype(np.float32)
    grids = jnp.asarray(grids_np)
    corners, valid, dirty = jmp.tile_corners(c, block, grid, order=order)
    nt = ps_np.shape[0] // block
    acc = jmp.gather_tiles(grids, c, f, corners, grid, block, order=order, interpret=True)
    acc = np.asarray(jmp.repair_gather(acc, grids, c, w, valid, dirty, nt, grid, block, order=order))
    xla = np.asarray(jp3m.tsc_gather(grids, c, w, grid) if order == 3 else jpm.cic_gather(grids, c, f, grid))
    got = mc.gather(torch.from_numpy(grids_np), c4, fm, grid, order).numpy()
    assert not got[:, 3].any()
    for want in (acc, xla):
        assert np.abs(got[:, :3] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("order", [3, 2])
def test_named_twins_match_jax_xla_forms(scene, order):
    """``tsc_deposit``/``cic_deposit`` and ``tsc_gather``/``cic_gather``
    (the JAX names) on positions, against the JAX XLA forms."""
    ps_np, n_real = scene
    grid = 32
    (c, w, f), (c4, fm), (lo, h) = cells(ps_np, n_real, grid, order)
    tps = torch.from_numpy(ps_np.copy())
    tlo, th = pm._box(tps[:n_real, :3], grid)
    if order == 3:
        got = p3m.tsc_deposit(tps[:, :3], tps[:, 3], tlo, th, grid).numpy()
        want = np.asarray(jp3m.tsc_deposit(jnp.asarray(ps_np[:, :3]), jnp.asarray(ps_np[:, 3]), lo, h, grid))
    else:
        got = pm.cic_deposit(tps[:, :3], tps[:, 3], tlo, th, grid).numpy()
        want = np.asarray(jpm.cic_deposit(jnp.asarray(ps_np[:, :3]), jnp.asarray(ps_np[:, 3]), lo, h, grid))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    grids_np = np.random.default_rng(5).standard_normal((3, grid**3)).astype(np.float32)
    tc, tf = c4[:, :3], fm[:, :3]
    if order == 3:
        got = p3m.tsc_gather(torch.from_numpy(grids_np), tc, tf, grid).numpy()
        want = np.asarray(jp3m.tsc_gather(jnp.asarray(grids_np), c, w, grid))
    else:
        got = pm.cic_gather(torch.from_numpy(grids_np), tc, tf, grid).numpy()
        want = np.asarray(jpm.cic_gather(jnp.asarray(grids_np), c, f, grid))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("grid", [16, 32])
def test_solve_potential_and_force_grids_match_jax(scene, grid):
    ps_np, n_real = scene
    (_, _, _), (c4, fm), (lo, h) = cells(ps_np, n_real, grid, 2)
    rho = mc.deposit(c4, fm, grid, 2)
    th = pm._box(torch.from_numpy(ps_np[:n_real, :3].copy()), grid)[1]
    assert float(th) == float(h)
    phi = pm.solve_potential(rho, th, EPS2)
    phi_j = jpm.solve_potential(jnp.asarray(rho.numpy()), h, EPS2)
    assert np.abs(phi.numpy() - np.asarray(phi_j)).max() <= 1e-4 * np.abs(np.asarray(phi_j)).max()
    fg, fg_j = pm.force_grids(phi, th).numpy(), np.asarray(jpm.force_grids(phi_j, h))
    assert np.abs(fg - fg_j).max() <= 1e-4 * np.abs(fg_j).max()


@pytest.mark.parametrize("grid", [32, 64])
def test_accel_pm_matches_jax(grid):
    pm_np, _, n_real = clustered()
    want = np.asarray(jpm.accel_pm(jnp.asarray(pm_np), G, grid=grid, eps2=EPS2, n_real=n_real))
    tpm = torch.from_numpy(pm_np)
    for backend in ("auto", "jnp"):
        got = pm.accel_pm(tpm, G, grid=grid, eps2=EPS2, n_real=n_real, mesh_backend=backend).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
        assert not got[:, 3].any()


def test_pm_step_matches_jax_five_steps():
    """``make_step_fn(method="pm")`` (the kernel route: on CPU the twins)
    against the JAX step (``backend="jnp"``) from the same state: rtol 1e-4."""
    pm_np, vel_np, n_real = clustered(1000, 1024)
    step = make_step_fn(SimConfig(method="pm", pm_grid=32), 1024, n_real, "cpu")
    jstep = jax_make_step_fn(JaxConfig(method="pm", pm_grid=32, backend="jnp"), 1024, n_real)
    s = SimState(torch.from_numpy(pm_np), torch.from_numpy(vel_np), torch.zeros((1024, 4)), 0)
    js = jax_init_state(pm_np, vel_np, n_pad=1024)
    for _ in range(5):
        s = step(s, 1e-3, G)
        js = jstep(js, 1e-3, G)
    for got, want in ((s.pos_mass, js.pos_mass), (s.vel, js.vel), (s.accel, js.accel)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_mesh_wrappers_refuse_bad_input(scene):
    ps_np, n_real = scene
    _, (c4, fm), _ = cells(ps_np, n_real, 32, 3)
    with pytest.raises(TypeError, match="int32"):
        mc.deposit(c4.float(), fm, 32, 3)
    with pytest.raises(ValueError, match="order"):
        mc.deposit(c4, fm, 32, 4)
    with pytest.raises(RuntimeError, match="never take such tensors"):
        mc.deposit(c4, fm.clone().requires_grad_(), 32, 3)
    with pytest.raises(ValueError, match="grids"):
        mc.gather(torch.zeros((3, 31**3)), c4, fm, 32, 3)
    with pytest.raises(ValueError, match="c4"):
        mc.gather(torch.zeros((3, 32**3)), c4[:-8].contiguous(), fm, 32, 3)


def test_mesh_launch_counts_stay_zero_on_cpu(scene):
    """On CPU tensors the wrappers take their twins and count nothing."""
    ps_np, n_real = scene
    _, (c4, fm), _ = cells(ps_np, n_real, 32, 3)
    reset_launch_counts()
    rho = mc.deposit(c4, fm, 32, 3)
    mc.gather(torch.zeros((3, 32**3)), c4, fm, 32, 3)
    pm.accel_pm(torch.from_numpy(ps_np.copy()), G, grid=32, n_real=n_real)
    assert rho.shape == (32, 32, 32)
    assert all(c == 0 for c in launch_counts().values())


ADVERSARIAL = {k: v for k, v in scatter_checks.deposit_adversarial().items() if not v[2]}


@pytest.mark.parametrize("order", [3, 2])
@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_deposit_twin_on_adversarial_scenes(name, order):
    """``scatter_checks``' isolated adversarial scenes (all bodies in one cell,
    unsorted blobs, Morton runs across octant boundaries), on which the card
    holds the kernel to this twin, against the JAX package's XLA deposit:
    1e-5 of the max; and both against the f64 sums of the twin's terms, each
    cell and the total within the bound of f32 summation in any order, with
    8 ulp a term for JAX's own rounding of its products (a
    pile-up of 8,190 terms in one cell leaves a fixed 1e-6 of the total)."""
    pm_np, n_real, _ = ADVERSARIAL[name]
    grid = 32
    c4, fm = scatter_checks.deposit_operands(pm_np, n_real, False, grid, order, torch.device("cpu"),
                                             sort=name != "shuffled")
    got = mc.deposit(c4, fm, grid, order).numpy()
    jps = jnp.asarray(pm_np)
    lo, h = jpm._box(jps[:n_real, :3], grid)
    want = np.asarray((jp3m.tsc_deposit if order == 3 else jpm.cic_deposit)(jps[:, :3], jps[:, 3], lo, h, grid))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    *_, rho64, allowed = scatter_checks.f32_sum_bounds(c4, fm, grid, order, term_ulps=8)
    for rho in (got, want):
        assert max(scatter_checks.f32_sum_excess(torch.tensor(rho), rho64, allowed)) <= 1.0
    if name == "one cell":
        base, count = torch.unique(c4[:, :3], dim=0, return_counts=True)
        assert int(count.max()) == pm_np.shape[0] - 2


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("order", [3, 2])
def test_deposit_checks_hold_the_twin(order, periodic):
    """The two checks the card holds every deposit to, on each adversarial
    scene of the boundary: each cell of the twin within its bound of f32
    summation in any order (``f32_sum_bounds``); and on exact terms (mass 1,
    weights 0, 1/2 or 1 an axis, as chip_smoke.py makes them) the f32 sums
    in a shuffled order equal to the f64 sums in every cell, so that one
    lost or repeated add shows even in a pile-up, where it is inside the
    first bound."""
    gen = torch.Generator().manual_seed(0)
    for name, (pm_np, n_real, per) in scatter_checks.deposit_adversarial().items():
        if per != periodic:
            continue
        c4, fm = scatter_checks.deposit_operands(pm_np, n_real, per, 32, order, torch.device("cpu"),
                                                 sort=name != "shuffled")
        *_, rho64, allowed = scatter_checks.f32_sum_bounds(c4, fm, 32, order, periodic=per)
        rho = mc.deposit(c4, fm, 32, order, periodic=per)
        assert max(scatter_checks.f32_sum_excess(rho, rho64, allowed)) <= 1.0, name
        exact = fm.clone()
        exact[:, :3] = 0.5 if order == 3 or per else 0.0
        exact[:, 3] = 1.0
        idx, val, rho64, _ = scatter_checks.f32_sum_bounds(c4, exact, 32, order, periodic=per)
        perm = torch.randperm(idx.shape[0], generator=gen)
        got = torch.zeros(32**3).index_add_(0, idx[perm], val[perm])
        assert torch.equal(got.double(), rho64) and float(got.sum()) == fm.shape[0], name
        k = int(torch.argmax(val))
        got[idx[k]] -= val[k]
        assert not torch.equal(got.double(), rho64), name
