"""The periodic box (``boundary="periodic"``), forward, of the port
against the JAX package on the CPU: the wrapped TSC/CIC cells bit for bit,
the periodic deposit and gather twins (what ``mesh_deposit`` and
``mesh_gather`` run on CPU tensors) against the XLA forms of
``mesh_accel_periodic_jnp``, the periodic tile selection bit for bit, the
periodic ``short_range`` twin against ``short_range_tiles(box=L)`` (the
Pallas kernel in interpret mode and the jnp form) and an f64 sum,
``accel_p3m``/``accel_pm`` and a 5-step rollout against JAX's and the f64
Ewald oracle, the engine's wrap and Ewald energy, the CLI, and the
refusal of direct + periodic.  Its gradients: ``test_torch_periodic_grad.py``.

Inputs: random boxes made with numpy from a seed, with bodies planted on
the seams (``tests/test_periodic.py``'s scenes and bounds: P3M against the
oracle median < 3e-3 and p99 < 2e-2, momentum < 3e-5 of sum |f|, the short
range atol 3e-6 of the max; against JAX rtol 1e-4, atol 1e-5 of the max,
the deposit and gather 1e-5 of the max)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.mesh_pallas as jmp  # noqa: E402
import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
import nbody3d_tpu.ops.pm as jpm  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.ops.ewald import ewald_accel_reference as jax_oracle  # noqa: E402
from nbody3d_tpu.ops.morton import morton_keys as jax_morton_keys  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import init_state as jax_init_state  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli, scatter_checks  # noqa: E402
from nbody3d_tpu_torch.ops import ewald, p3m, pm  # noqa: E402
from nbody3d_tpu_torch.ops import mesh_cuda as mc  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

L = 1.0
G = 1.0


def box_scene(n, n_pad=None, seed=0):
    """``n`` bodies uniform in ``[0, L)³``, masses U(1, 3), eight planted on
    the seams (a coordinate at 0, at ``L - 1e-7`` or a hair from it; one in
    the far corner, whose stencil wraps onto the first and the last cell,
    kept 3.5e-3 from the padding rows at the origin: a pair much closer
    than the softening cancels ``1/s³ - 1/r³`` to nothing in f32, in
    either package), zero-padded to ``n_pad`` rows."""
    rng = np.random.default_rng(seed)
    pm_np = np.concatenate([rng.uniform(0, L, (n, 3)), rng.uniform(1.0, 3.0, (n, 1))], axis=1)
    pm_np[:8, :3] = [[0.0, 0.5, 0.0], [L - 1e-7, 0.5, 0.5], [0.5, 0.0, L - 1e-7], [L - 2e-3, L - 2e-3, L - 2e-3],
                     [1e-7, 0.25, 0.75], [0.75, 1e-7, L - 1e-7], [0.5, 0.5, 0.0], [L - 2e-7, 2e-7, 0.3]]
    n_pad = n if n_pad is None else n_pad
    return np.pad(pm_np, ((0, n_pad - n), (0, 0))).astype(np.float32)


def sorted_box(pm_np, n_real):
    """The wrapped rows Morton-sorted as both packages sort them."""
    jps = jnp.asarray(pm_np)[jnp.argsort(jax_morton_keys(jnp.asarray(pm_np), n_real), stable=True)]
    return np.asarray(jps)


def rel_per_body(got, ref):
    return np.linalg.norm(got - ref, axis=1) / np.maximum(np.linalg.norm(ref, axis=1), 1e-20)


@pytest.fixture(scope="module")
def scene():
    return sorted_box(box_scene(4000, 4096, seed=1), 4000)


def periodic_cells(ps_np, grid, order):
    """``(jax cells, torch (c4, fm))`` of the periodic box, asserted
    bit-equal."""
    jps, tps = jnp.asarray(ps_np), torch.from_numpy(ps_np.copy())
    h, th = jnp.float32(L) / grid, torch.tensor(L, dtype=torch.float32) / grid
    lo, tlo = jnp.zeros(3, jnp.float32), torch.zeros(3)
    if order == 3:
        c, w, f = jp3m._tsc_cells(jps[:, :3], lo, h, grid, periodic=True)
        jcells = (c, w)
    else:
        c, f = jpm._cic_cells(jps[:, :3], lo, h, grid, periodic=True)
        jcells = (c, f)
    tc, tf = (p3m._tsc_cells if order == 3 else pm._cic_cells)(tps[:, :3], tlo, th, grid, periodic=True)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(f))
    return jcells, mc.mesh_operands(tc, tf, tps[:, 3])


@pytest.mark.parametrize("order", [3, 2])
def test_periodic_deposit_twin_matches_jax(scene, order):
    """The twin against JAX's periodic XLA deposit (1e-5 of the max, total
    mass 1e-6); the seam bodies reach both faces' cells; with exact terms
    (mass 1, f = 1/2: weights 0, 1/2, 1/2 or 1/2, 1/2 an axis) every cell
    equals its f64 sum, the first and the last cell among them."""
    grid = 32
    _, (c4, fm) = periodic_cells(scene, grid, order)
    got = mc.deposit(c4, fm, grid, order, periodic=True).numpy()
    jps = jnp.asarray(scene)
    dep = jp3m.tsc_deposit if order == 3 else jpm.cic_deposit
    want = np.asarray(dep(jps[:, :3], jps[:, 3], jnp.zeros(3), jnp.float32(L) / grid, grid, periodic=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(got.sum() / want.sum() - 1.0) <= 1e-6
    for axis in range(3):
        faces = np.moveaxis(got, axis, 0)
        assert faces[0].sum() > 0 and faces[-1].sum() > 0
    exact = fm.clone()
    exact[:, :3] = 0.5
    exact[:, 3] = (fm[:, 3] != 0).float()
    ones = mc.deposit(c4, exact, grid, order, periodic=True).view(-1)
    idx, val = zip(*mc._stencil(c4, exact[:, :3].double(), grid, order, mass=exact[:, 3].double(), periodic=True))
    f64 = torch.zeros(grid**3, dtype=torch.float64).index_add_(0, torch.cat(idx), torch.cat(val))
    assert torch.equal(ones.double(), f64) and float(ones.sum()) == 4000.0
    assert ones[0] > 0 and ones[-1] > 0


@pytest.mark.parametrize("order", [3, 2])
def test_periodic_gather_twin_matches_jax(scene, order):
    grid = 32
    (jc, jw), (c4, fm) = periodic_cells(scene, grid, order)
    grids = np.random.default_rng(order).normal(size=(3, grid**3)).astype(np.float32)
    got = mc.gather(torch.from_numpy(grids), c4, fm, grid, order, periodic=True).numpy()
    gat = jp3m.tsc_gather if order == 3 else jpm.cic_gather
    want = np.asarray(gat(jnp.asarray(grids), jc, jw, grid))
    assert not got[:, 3].any()
    assert np.abs(got[:, :3] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("order", [3, 2])
def test_periodic_mesh_leg_matches_jax(scene, order):
    """Deposit, spectral solve and gather against ``mesh_accel_periodic_jnp``
    (mesh_pallas.py:767)."""
    grid = 32
    sigma = 1.5 * L / grid
    tps = torch.from_numpy(scene.copy())
    got = p3m.periodic_mesh_leg(tps[:, :3], tps[:, 3], torch.tensor(L), torch.tensor(sigma), grid, order,
                                plain=False).numpy()
    want = np.asarray(jmp.mesh_accel_periodic_jnp(jnp.asarray(scene), jnp.float32(L), jnp.float32(sigma),
                                                  grid=grid, order=order))
    np.testing.assert_allclose(got[:, :3], want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def jax_select(lo_b, hi_b, h, k, Lj):
    nb = lo_b.shape[0]
    return jax.jit(lambda a, b, c, d: jp3m._select_neighbors(a, b, 0, nb, c, k, L=d))(lo_b, hi_b, h, Lj)


@pytest.mark.parametrize("block,k,flat_max", [(64, 8, None), (32, 16, None), (16, 24, 4)])
def test_periodic_selection_matches_jax(scene, monkeypatch, block, k, flat_max):
    """The periodic AABB gap, the lists, the k-th distances and the mutual
    mask bit-equal to JAX's compiled selection, flat and (``flat_max`` 4)
    two-level; tiles across a seam are near."""
    if flat_max is not None:
        monkeypatch.setattr(p3m, "_FLAT_MAX_TILES", flat_max)
        monkeypatch.setattr(jp3m, "_FLAT_MAX_TILES", flat_max)
    n_real = 4000
    h = jnp.float32(L) / 32
    lo_b, hi_b = jp3m._sorted_aabbs(jnp.asarray(scene), n_real, block)
    tlo, thi = p3m._sorted_aabbs(torch.from_numpy(scene.copy()), n_real, block)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo_b))
    # Compiled on its own, XLA contracts the sum of squares in another
    # order than inside the selection (which the lists below hold bit for
    # bit): the distances agree to an ulp.
    d2 = jax.jit(lambda a, b: jp3m._aabb_dist2(a, b, L=jnp.float32(L)))(lo_b, hi_b)
    td2 = p3m._aabb_dist2(tlo, thi, tlo, thi, torch.tensor(L))
    np.testing.assert_allclose(td2.numpy(), np.asarray(d2), rtol=2.0**-22, atol=0)
    assert (td2.numpy() == np.float32(1e30)).any()  # the padding tiles
    kth, neg, idx = jax_select(lo_b, hi_b, h, k, jnp.float32(L))
    tk, tn, ti = p3m._select_neighbors(tlo, thi, torch.tensor(L) / 32, k, L=torch.tensor(L))
    rows = -(-n_real // block)
    for a, b in ((tk, kth), (tn, neg), (ti, idx)):
        np.testing.assert_array_equal(a.numpy()[:rows], np.asarray(b)[:rows])
    tm = p3m.mutual_neighbor_mask(tn, ti, tk).numpy()
    np.testing.assert_array_equal(tm[:rows], np.asarray(jp3m.mutual_neighbor_mask(neg, idx, kth))[:rows])
    iso = p3m._aabb_dist2(tlo, thi, tlo, thi)
    assert (td2 < iso).any()  # some tiles are nearer through a seam


def _short_range_f64(ps, idx, mask, eps2, sigma, rcut, block):
    """The periodic short range summed in f64 from the same f32 rows."""
    ps = torch.from_numpy(ps).double()
    nb, k = idx.shape
    out = torch.zeros((ps.shape[0], 3), dtype=torch.float64)
    for t in range(nb):
        tgt = ps[t * block : (t + 1) * block]
        for s in range(k):
            if mask[t, s] == 0:
                continue
            src = ps[int(idx[t, s]) * block : (int(idx[t, s]) + 1) * block]
            d = p3m.min_image(src[None, :, :3] - tgt[:, None, :3], L)
            r2 = torch.sum(d * d, dim=-1)
            w = ewald.k_short_periodic(r2, eps2, torch.tensor(sigma, dtype=torch.float64)) * src[:, 3]
            w = torch.where((r2 > 0) & (r2 < rcut * rcut), w, 0.0)
            out[t * block : (t + 1) * block] += float(mask[t, s]) * torch.einsum("ij,ijc->ic", w, d)
    return out.numpy()


@pytest.mark.parametrize("block,nbr_k", [(64, 4), (32, 8)])
def test_periodic_short_range_twin_matches_jax(block, nbr_k):
    """The twin against ``short_range_tiles(box=L)`` in interpret mode and
    the jnp form, and against an f64 sum of the same pairs: atol 3e-6 of
    the max (tests/test_periodic.py:147-177; the A-S erfc against the
    exact one, and 1/s³ - 1/r³ cancelling in f32)."""
    n = 512
    ps = sorted_box(box_scene(n, seed=7), n)
    jps = jnp.asarray(ps)
    nb = n // block
    h = jnp.float32(L / 16)
    sigma, rcut = 1.5 * h, 4.5 * 1.5 * h
    lo_b, hi_b = jp3m._sorted_aabbs(jps, n, block)
    kth, neg, idx = jax_select(lo_b, hi_b, h, nbr_k, jnp.float32(L))
    mask = jp3m.mutual_neighbor_mask(neg, idx, kth)
    kw = dict(nbr_mask=mask, box=jnp.float32(L))
    ref = np.asarray(jp3m.short_range_tiles(jps, idx, 0, nb, 1e-6, sigma, rcut, block, backend="jnp", **kw))
    pal = np.asarray(jp3m.short_range_tiles(jps, idx, 0, nb, 1e-6, sigma, rcut, block, backend="pallas",
                                            interpret=True, **kw))
    tidx, tmask = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(mask))
    got = p3m.short_range_tiles(torch.from_numpy(ps.copy()), tidx, 1e-6, torch.tensor(float(sigma)), torch.tensor(float(rcut)),
                                block, tmask, box=L).numpy()
    f64 = _short_range_f64(ps, np.array(idx), np.array(mask), 1e-6, float(sigma), float(rcut), block)
    assert not got[:, 3].any() and (np.array(mask) == 0).any()
    for want in (ref, pal[:, :3], f64):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[:, :3] / scale, want / scale, atol=3e-6)


@pytest.fixture(scope="module")
def p3m_accels():
    """Port and JAX periodic P3M, interlace off and on, on a 4,000-body box
    in 4,096 rows, grid 32, k 16, block 256; and JAX's on 512 bodies."""
    pm_np = box_scene(4000, 4096, seed=3)
    kw = dict(grid=32, eps2=1e-6, n_real=4000, nbr_k=16, block=256, boundary="periodic", box_size=L)
    out = {}
    for il in (False, True):
        got = p3m.accel_p3m(torch.from_numpy(pm_np), G, interlace=il, **kw).numpy()
        want = np.asarray(jp3m.accel_p3m(jnp.asarray(pm_np), G, short_backend="jnp", mesh_backend="jnp",
                                         interlace=il, **kw))
        out[il] = got, want
    return pm_np, out


@pytest.mark.parametrize("interlace", [False, True])
def test_accel_p3m_periodic_matches_jax(p3m_accels, interlace):
    pm_np, out = p3m_accels
    got, want = out[interlace]
    assert not got[:, 3].any() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _oracle(pm_np, sigma, eps2):
    """The f64 Ewald oracle of the port (tests/test_periodic.py's kmax)."""
    kmax = max(10, int(5.5 * L / (2 * np.pi * sigma)) + 1)
    return ewald.ewald_accel_reference(torch.from_numpy(pm_np).double(), L, sigma, eps2=eps2, n_images=2,
                                       kmax=kmax).numpy()


def test_accel_p3m_periodic_meets_ewald_oracle():
    """tests/test_periodic.py:44-59 and :96-119 on the port and on JAX: the
    512-body box against the f64 Ewald oracle, median < 3e-3, p99 < 2e-2,
    and interlacing cuts the median error below 0.7x."""
    pm_np = box_scene(512, seed=1)
    ref = _oracle(pm_np, 1.5 * L / 32, 1e-6)
    kw = dict(grid=32, eps2=1e-6, nbr_k=8, boundary="periodic", box_size=L)
    med = {}
    for il in (False, True):
        got = p3m.accel_p3m(torch.from_numpy(pm_np), G, interlace=il, **kw).numpy()[:, :3]
        want = np.asarray(jp3m.accel_p3m(jnp.asarray(pm_np), G, short_backend="jnp", interlace=il, **kw))[:, :3]
        for a in (got, want):
            rel = rel_per_body(a, ref)
            assert np.median(rel) < 3e-3 and np.percentile(rel, 99) < 2e-2
        med[il] = np.median(rel_per_body(got, ref))
    assert med[True] < 0.7 * med[False]


def test_periodic_wrap_seam_pair():
    """A tight pair through the seam feels the force of the same pair at
    the box centre (tests/test_periodic.py:61-94), on the kernel route."""
    d = 0.04
    base = np.array([[1.0 - d / 2, 0.31, 0.47, 10.0], [d / 2, 0.31, 0.47, 20.0]], np.float32)
    spect = np.array([[0.5, 0.81, 0.12, 1.0]], np.float32)
    pm_seam = np.concatenate([base, spect] + [spect] * 13)
    center = pm_seam.copy()
    center[:, 0] = (center[:, 0] + 0.5) % L
    kw = dict(grid=32, eps2=1e-6, nbr_k=4, boundary="periodic", box_size=L)
    a_seam = p3m.accel_p3m(torch.from_numpy(pm_seam), G, **kw).numpy()
    a_cent = p3m.accel_p3m(torch.from_numpy(center), G, **kw).numpy()
    scale = np.abs(a_cent[:2]).max()
    np.testing.assert_allclose(a_seam[:2] / scale, a_cent[:2] / scale, atol=2e-3)
    assert a_seam[0, 0] > 0.1 * scale and a_seam[1, 0] < -0.1 * scale


def test_periodic_rcut_guard():
    with pytest.raises(ValueError, match="minimum image"):
        p3m.accel_p3m(torch.from_numpy(box_scene(64)), G, grid=8, boundary="periodic", box_size=L)
    with pytest.raises(ValueError, match="box_size > 0"):
        p3m.accel_p3m(torch.from_numpy(box_scene(64)), G, grid=32, boundary="periodic")
    with pytest.raises(ValueError, match="box_size > 0"):
        pm.accel_pm(torch.from_numpy(box_scene(64)), G, grid=32, boundary="periodic")


@pytest.mark.parametrize("method,interlace", [("p3m", False), ("p3m", True), ("pm", False), ("pm", True)])
def test_periodic_momentum(method, interlace):
    """The net force is below 3e-5 of sum |f| (tests/test_periodic.py:121-145)."""
    n = 2048 if method == "pm" else 1024
    pm_np = box_scene(n, seed=5)
    if method == "p3m":
        a = p3m.accel_p3m(torch.from_numpy(pm_np), G, grid=32, eps2=1e-6, nbr_k=8, boundary="periodic",
                          box_size=L, interlace=interlace)
    else:
        a = pm.accel_pm(torch.from_numpy(pm_np), G, grid=32, boundary="periodic", box_size=L, interlace=interlace)
    f = pm_np[:, 3:4] * a.numpy()[:, :3]
    assert np.abs(f.sum(axis=0)).max() < 3e-5 * np.abs(f).sum()


@pytest.mark.parametrize("interlace", [False, True])
def test_accel_pm_periodic_matches_jax(interlace):
    pm_np = box_scene(4000, 4096, seed=2)
    kw = dict(grid=32, boundary="periodic", box_size=L, interlace=interlace)
    want = np.asarray(jpm.accel_pm(jnp.asarray(pm_np), G, **kw))
    for backend in ("auto", "jnp"):
        got = pm.accel_pm(torch.from_numpy(pm_np), G, mesh_backend=backend, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_pm_periodic_wrap_invariance():
    """A shift by a whole number of cells reproduces the forces
    (tests/test_periodic.py:289-305): a wrapped-stencil bug shows here."""
    grid = 32
    pm_np = box_scene(256, seed=8)
    pm2 = pm_np.copy()
    pm2[:, :3] = (pm2[:, :3] + np.float32(14 / grid) * L) % L
    kw = dict(grid=grid, boundary="periodic", box_size=L)
    a1 = pm.accel_pm(torch.from_numpy(pm_np), G, **kw).numpy()[:, :3]
    a2 = pm.accel_pm(torch.from_numpy(pm2), G, **kw).numpy()[:, :3]
    scale = np.abs(a1).max()
    np.testing.assert_allclose(a1 / scale, a2 / scale, atol=2e-5)


@pytest.mark.parametrize("method,interlace", [("p3m", False), ("p3m", True), ("pm", False)])
def test_periodic_step_matches_jax_five_steps(method, interlace):
    """``make_step_fn`` (the kernel route: on CPU the twins) against the JAX
    step (``backend="jnp"``), 5 steps of a 1,000-body box in 1,024 rows:
    rtol 1e-4, atol 1e-5 of the max."""
    pm_np = box_scene(1000, 1024, seed=9)
    vel_np = np.zeros_like(pm_np)
    vel_np[:1000, :3] = np.random.default_rng(9).normal(scale=0.3, size=(1000, 3))
    cfg = dict(method=method, pm_grid=16, p3m_nbr_k=4, boundary="periodic", box_size=L, mesh_interlace=interlace)
    step = make_step_fn(SimConfig(**cfg), 1024, 1000, "cpu")
    jstep = jax_make_step_fn(JaxConfig(backend="jnp", **cfg), 1024, 1000)
    s = SimState(torch.from_numpy(pm_np), torch.from_numpy(vel_np), torch.zeros((1024, 4)), 0)
    js = jax_init_state(pm_np, vel_np, n_pad=1024)
    for _ in range(5):
        s = step(s, 2e-4, 2e-3)
        js = jstep(js, 2e-4, 2e-3)
    for got, want in ((s.pos_mass, js.pos_mass), (s.vel, js.vel), (s.accel, js.accel)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_engine_wraps_box_and_ewald_energy_matches_jax():
    """``Simulation``: the chunk-boundary wrap brings bodies outside the box
    back into it, and the periodic diagnostics are the f64 Ewald energy, as
    the JAX engine's (1e-12 relative at the start, 1e-6 after 20 steps;
    momentum to 1e-6 of sum |m v|)."""
    cfg = dict(method="p3m", boundary="periodic", box_size=1.0, pm_grid=32, p3m_nbr_k=8, dt=2e-4, G=2e-3)
    pm_np = box_scene(512, seed=11)
    pm_np[:3, 0] = [-0.25, 1.25, 3.0]
    vel_np = np.zeros_like(pm_np)
    sim = Simulation(SimConfig(**cfg), pm_np, vel_np, device="cpu")
    jsim = JaxSimulation(JaxConfig(backend="jnp", **cfg), pm_np, vel_np)
    d0, jd0 = sim.diagnostics(), jsim.diagnostics()
    assert float(d0.kinetic) == 0.0
    assert abs(float(d0.total_energy) - float(jd0.total_energy)) <= 1e-12 * abs(float(jd0.total_energy))
    sim.run(20, chunk=10)
    jsim.run(20, chunk=10)
    p, v, _ = sim.arrays()
    assert p[:, :3].min() >= 0.0 and p[:, :3].max() < 1.0
    d1, jd1 = sim.diagnostics(), jsim.diagnostics()
    assert float(d1.kinetic) > 0.0
    assert abs(float(d1.total_energy) - float(jd1.total_energy)) <= 1e-6 * abs(float(jd1.total_energy))
    pscale = float(np.abs(p[:, 3:4] * v[:, :3]).sum())
    assert np.abs(d1.momentum - np.asarray(jd1.momentum)).max() <= 1e-6 * pscale


def test_cli_run_uniform_box(capsys, tmp_path):
    """tests/test_periodic.py:272-287 through the port's CLI on the CPU:
    the state stays in the box and nothing launches."""
    reset_launch_counts()
    outdir = tmp_path / "out"
    rc = cli.main(["run", "--device", "cpu", "--preset", "uniform-box", "--n", "256", "--steps", "4",
                   "--method", "p3m", "--boundary", "periodic", "--box-size", "5", "--pm-grid", "16",
                   "--interlace", "--log-every", "2", "--diagnostics", "--outdir", str(outdir)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "step=4" in out and "E=" in out
    arr = np.load(outdir / "final.npz")["pos_mass"]
    assert arr[:, :3].min() >= 0 and arr[:, :3].max() < 5.0 and arr[:, :3].max() > 2.5
    sim = Simulation.load(str(outdir / "final.npz"), device="cpu")
    assert sim.config.boundary == "periodic" and sim.config.box_size == 5.0 and sim.config.mesh_interlace
    assert all(c == 0 for c in launch_counts().values())


@pytest.mark.parametrize("kw", [{}, {"cosmology": "eds"}, {"force_mode": "sym"}])
def test_direct_periodic_raises_value_error(kw):
    """As ``nbody3d_tpu/ops/step.py:282-288``: the direct kernels sum bare
    pairs, which the torus does not define."""
    with pytest.raises(ValueError, match="needs a mesh solver"):
        Simulation.from_preset("uniform-box", SimConfig(boundary="periodic", box_size=10.0, **kw), n=256,
                               device="cpu")


def test_periodic_tiles_within_rcut_and_overflow():
    """The per-tile count of tiles within rcut through the periodic gap
    equals a count from JAX's periodic ``_aabb_dist2``, and the overflow is
    the rows with more of them than ``nbr_k``."""
    pm_np = box_scene(4000, 4096, seed=6)
    kw = dict(grid=32, n_real=4000, block=64, box_size=L)
    within = p3m.tiles_within_rcut(torch.from_numpy(pm_np), **kw).numpy()
    jps = jnp.asarray(sorted_box(pm_np, 4000))
    lo_b, hi_b = jp3m._sorted_aabbs(jps, 4000, 64)
    rcut = 4.5 * 1.5 * jnp.float32(L) / 32
    want = np.asarray(jnp.sum(jp3m._aabb_dist2(lo_b, hi_b, L=jnp.float32(L)) < rcut * rcut, axis=1))
    np.testing.assert_array_equal(within, want)
    for k in (4, 16, 64):
        assert p3m.p3m_neighbor_overflow(torch.from_numpy(pm_np), nbr_k=k, **kw) == int((want > k).sum())


ADVERSARIAL = {k: v for k, v in scatter_checks.deposit_adversarial().items() if v[2]}


@pytest.mark.parametrize("order", [3, 2])
@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_periodic_deposit_twin_on_adversarial_scenes(name, order):
    """``scatter_checks``' periodic adversarial scenes (all bodies in one cell
    by the far corner, a cube about the torus' corner whose Morton runs
    cross the seams, uniform runs across octant boundaries), on which the
    card holds the kernel to this twin, against JAX's periodic XLA deposit:
    1e-5 of the max; and both against the f64 sums of the twin's terms, each
    cell and the total within the bound of f32 summation in any order, with
    8 ulp a term for JAX's own rounding of its products (a
    pile-up of 8,192 terms in one cell leaves a fixed 1e-6 of the total)."""
    pm_np, n_real, _ = ADVERSARIAL[name]
    grid = 32
    c4, fm = scatter_checks.deposit_operands(pm_np, n_real, True, grid, order, torch.device("cpu"))
    got = mc.deposit(c4, fm, grid, order, periodic=True).numpy()
    jps = jnp.asarray(pm_np)
    dep = jp3m.tsc_deposit if order == 3 else jpm.cic_deposit
    want = np.asarray(dep(jps[:, :3], jps[:, 3], jnp.zeros(3), jnp.float32(L) / grid, grid, periodic=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    *_, rho64, allowed = scatter_checks.f32_sum_bounds(c4, fm, grid, order, periodic=True, term_ulps=8)
    for rho in (got, want):
        assert max(scatter_checks.f32_sum_excess(torch.tensor(rho), rho64, allowed)) <= 1.0
    if name == "seam, periodic":
        for axis in range(3):
            faces = np.moveaxis(got, axis, 0)
            assert faces[0].sum() > 0 and faces[-1].sum() > 0
