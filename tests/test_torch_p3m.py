"""P3M (``ops/p3m.py``) against the JAX package on the CPU: the neighbour
selection and the heavy split exactly, the short-range twin (what the
``short_range`` wrapper runs on CPU tensors) against the Pallas kernel in
interpret mode and the jnp form, the long-range solve, the accelerations,
a 5-step rollout and the CLI; and the port's own contract against the
direct sum.

Inputs are the JAX P3M tests' clustered scene (``tests/test_p3m.py``):
the two-galaxy preset at n = 4,096 (two 1e7 centres among them), zero-padded
to 8,192 rows.  Bounds are the JAX tests': the short range rtol 2e-4 and
atol 3e-6 of the max (the A-S erfc against the exact one), the solves 1e-4
of the max, the accelerations and the rollout rtol 1e-4 and atol 1e-5 of
the max, against direct a median below 2e-3 and a p99 below 1e-2."""

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
from nbody3d_tpu.ops.force_jnp import accel_direct as jax_accel_direct  # noqa: E402
from nbody3d_tpu.ops.morton import morton_keys as jax_morton_keys  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import init_state as jax_init_state  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli, pair_checks  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
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


def rel_per_body(got, ref):
    return np.linalg.norm(got[:, :3] - ref[:, :3], axis=1) / np.maximum(np.linalg.norm(ref[:, :3], axis=1), 1e-20)


@pytest.fixture(scope="module")
def scene():
    pm_np, vel_np, n_real = clustered()
    return pm_np, vel_np, n_real


@pytest.fixture(scope="module")
def accels(scene):
    """The port's P3M (kernel route: the twins on CPU), the JAX package's
    (jnp short range and mesh) and the direct sum, grid 32, k 32."""
    pm_np, _, n_real = scene
    kw = dict(grid=32, eps2=EPS2, n_real=n_real, nbr_k=32)
    got = p3m.accel_p3m(torch.from_numpy(pm_np), G, **kw).numpy()
    want = np.asarray(jp3m.accel_p3m(jnp.asarray(pm_np), G, short_backend="jnp", mesh_backend="jnp", **kw))
    direct = np.asarray(jax_accel_direct(jnp.asarray(pm_np), G, eps2=EPS2))
    return got, want, direct


def sorted_tiles(pm_np, n_real, grid, block):
    """The sorted rows, box and tile AABBs on both sides."""
    jpm_ = jnp.asarray(pm_np)
    _, h = jpm._box(jpm_[:n_real, :3], grid)
    jps = jpm_[jnp.argsort(jax_morton_keys(jpm_, n_real), stable=True)]
    lo_b, hi_b = jp3m._sorted_aabbs(jps, n_real, block)
    tpm = torch.from_numpy(pm_np.copy())
    _, th = pm._box(tpm[:n_real, :3], grid)
    tps = tpm[torch.argsort(p3m.morton_keys(tpm, n_real), stable=True)]
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    tlo, thi = p3m._sorted_aabbs(tps, n_real, block)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo_b))
    return (jps, lo_b, hi_b, h), (tps, tlo, thi, th)


def jax_select(lo_b, hi_b, h, k, hier_kw=None):
    """JAX's selection compiled, as every caller of it runs."""
    nb = lo_b.shape[0]
    if hier_kw is None:
        return jax.jit(lambda a, b, c: jp3m._select_neighbors(a, b, 0, nb, c, k))(lo_b, hi_b, h)
    return jax.jit(lambda a, b, c: jp3m._select_neighbors_hier(a, b, 0, nb, c, k, **hier_kw))(lo_b, hi_b, h)


def pair_set(mask, idx):
    """The (target tile, source tile) pairs a mask keeps, as a bool matrix."""
    nb = idx.shape[0]
    keep = np.zeros((nb, nb), bool)
    live = np.asarray(mask) > 0
    keep[np.nonzero(live)[0], np.asarray(idx)[live]] = True
    return keep


def assert_selection_equal(got, want, n_real, block):
    """``nbr_idx``, ``kth`` and the mutual mask equal on the real tiles.
    The port's mask also kills the two-level selection's non-admitted slots
    (``p3m.mutual_neighbor_mask``), where the JAX mask can keep a pair on
    one side only: there it is 0, everywhere else JAX's, and its pair set
    is symmetric."""
    (tk, tn, ti), (kth, neg, idx) = got, want
    rows = -(-n_real // block)
    np.testing.assert_array_equal(ti.numpy()[:rows], np.asarray(idx)[:rows])
    np.testing.assert_array_equal(tk.numpy()[:rows], np.asarray(kth)[:rows])
    np.testing.assert_array_equal(tn.numpy()[:rows], np.asarray(neg)[:rows])
    tm = p3m.mutual_neighbor_mask(tn, ti, tk).numpy()
    jm = np.asarray(jp3m.mutual_neighbor_mask(neg, idx, kth))
    dead = -np.asarray(neg) == np.float32(p3m._NOT_ADMITTED)
    np.testing.assert_array_equal(tm[:rows][~dead[:rows]], jm[:rows][~dead[:rows]])
    assert not tm[dead].any()
    keep = pair_set(tm, ti)[:rows, :rows]  # all-padding tiles carry no mass
    assert not (keep & ~keep.T).any()
    return tm, pair_set(jm, idx)[:rows, :rows]


@pytest.mark.parametrize("block", [64, 128, 256])
def test_flat_selection_matches_jax(scene, block):
    pm_np, _, n_real = scene
    (_, lo_b, hi_b, h), (_, tlo, thi, th) = sorted_tiles(pm_np, n_real, 32, block)
    mask, jax_pairs = assert_selection_equal(p3m._select_neighbors(tlo, thi, th, 32),
                                             jax_select(lo_b, hi_b, h, 32), n_real, block)
    assert mask.sum() > 0 and not (jax_pairs & ~jax_pairs.T).any()


@pytest.mark.parametrize(
    "n,n_pad,block,hier_kw",
    [
        (4096, 8192, 64, {}),  # 128 tiles, supers of 32: every super admitted
        (4096, 8192, 16, {"nbr_k": 24}),  # 512 tiles, 16 supers over the k_s = 12 budget
        (40000, 40192, 256, {}),  # 157 tiles: odd, supers of 1 (the 2M shape's case)
        (4096, 8192, 32, {"sup_k": 2, "nbr_k": 8}),  # starved at both levels
    ],
)
def test_hier_selection_matches_jax(monkeypatch, n, n_pad, block, hier_kw):
    """The two-level selection, through ``_select_neighbors`` with
    ``_FLAT_MAX_TILES`` at 4 (as tests/test_p3m.py forces it) or called
    directly with a starved super budget."""
    pm_np, _, n_real = clustered(n, n_pad)
    (_, lo_b, hi_b, h), (_, tlo, thi, th) = sorted_tiles(pm_np, n_real, 32, block)
    k = hier_kw.get("nbr_k", 32)
    if "sup_k" in hier_kw:
        got = p3m._select_neighbors_hier(tlo, thi, th, k, sup_k=hier_kw["sup_k"])
        want = jax_select(lo_b, hi_b, h, k, {"sup_k": hier_kw["sup_k"]})
    else:
        monkeypatch.setattr(p3m, "_FLAT_MAX_TILES", 4)
        monkeypatch.setattr(jp3m, "_FLAT_MAX_TILES", 4)
        got = p3m._select_neighbors(tlo, thi, th, k)
        want = jax_select(lo_b, hi_b, h, k)
    _, jax_pairs = assert_selection_equal(got, want, n_real, block)
    if n_pad == 40192:
        # Supers of one tile leave rows short of admitted candidates, and
        # the JAX mask keeps some of their pairs on one side only.
        assert (jax_pairs & ~jax_pairs.T).any()


def test_selection_keeps_self_under_ties():
    """256 identical AABBs and starved budgets: every row keeps its own tile,
    at the pinned -1e30 (tests/test_p3m.py's case)."""
    lo_b, hi_b, h = torch.zeros((256, 3)), torch.ones((256, 3)), torch.tensor(1.0)
    for kth, neg, idx in (p3m._select_neighbors(lo_b, hi_b, h, 4),
                          p3m._select_neighbors_hier(lo_b, hi_b, h, 4, sup_k=2)):
        hit = idx.numpy() == np.arange(256)[:, None]
        assert hit.any(axis=1).all()
        assert (neg.numpy()[hit] == np.float32(1e30)).all()


@pytest.mark.parametrize("block,nbr_k", [(256, 2), (256, 32), (16, 256)])
def test_neighbor_overflow_matches_jax(scene, monkeypatch, block, nbr_k):
    pm_np, _, n_real = scene
    kw = dict(grid=32, n_real=n_real, block=block, nbr_k=nbr_k)
    want = int(jp3m.p3m_neighbor_overflow.__wrapped__(jnp.asarray(pm_np), **kw))
    assert p3m.p3m_neighbor_overflow(torch.from_numpy(pm_np), **kw) == want
    if block == 16:  # the two-level count: 512 tiles past a patched flat cap
        monkeypatch.setattr(p3m, "_FLAT_MAX_TILES", 4)
        monkeypatch.setattr(jp3m, "_FLAT_MAX_TILES", 4)
        want = int(jp3m.p3m_neighbor_overflow.__wrapped__(jnp.asarray(pm_np), **kw))
        assert p3m.p3m_neighbor_overflow(torch.from_numpy(pm_np), **kw) == want
    elif nbr_k == 2:
        assert want > 0


def test_heavy_split_matches_jax_tie_break(scene):
    """Two 1e7 centres and 14 light bodies chosen among equal masses: the
    indices equal ``lax.top_k``'s (the lower index first among ties)."""
    pm_np, _, _ = scene
    ties = pm_np.copy()
    ties[100:4000:7, 3] = 77.0  # many equal masses above the disk's range
    for arr in (pm_np, ties):
        hidx, mass = p3m.heavy_split(torch.from_numpy(arr.copy()), 16)
        jhidx, jmass = jp3m.heavy_split(jnp.asarray(arr), 16)
        np.testing.assert_array_equal(hidx.numpy(), np.asarray(jhidx))
        np.testing.assert_array_equal(mass.numpy(), np.asarray(jmass))


def test_heavy_direct_matches_jax(scene):
    pm_np, _, _ = scene
    hidx = np.asarray(jp3m.heavy_split(jnp.asarray(pm_np), 16)[0])
    got = p3m.heavy_direct(torch.from_numpy(pm_np.copy()), torch.from_numpy(hidx.copy()).long(), EPS2)
    want = jp3m.heavy_direct(jnp.asarray(pm_np), jnp.asarray(hidx), EPS2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("block,nbr_k", [(128, 8), (256, 8)])
def test_short_range_twin_matches_jax(scene, block, nbr_k):
    """The twin against the Pallas kernel (interpret mode) and the jnp form
    on the same sorted rows, lists and mutual mask."""
    pm_np, _, n_real = scene
    grid = 32
    (jps, lo_b, hi_b, h), (tps, tlo, thi, th) = sorted_tiles(pm_np, n_real, grid, block)
    sigma, rcut = jp3m.DEFAULT_SIGMA_CELLS * h, jp3m.DEFAULT_RCUT_SIGMAS * jp3m.DEFAULT_SIGMA_CELLS * h
    kth, neg, idx = jax_select(lo_b, hi_b, h, nbr_k)
    mask = jp3m.mutual_neighbor_mask(neg, idx, kth)
    nb = pm_np.shape[0] // block
    ref = np.asarray(jp3m._short_range_tiles(jps, idx, 0, nb, EPS2, sigma, rcut, block, nbr_mask=mask))
    pal = np.asarray(jp3m._short_range_tiles_pallas(jps, idx, 0, nb, EPS2, sigma, rcut, block, nbr_mask=mask,
                                                    interpret=True))
    tsig, trcut = p3m.DEFAULT_SIGMA_CELLS * th, p3m.DEFAULT_RCUT_SIGMAS * p3m.DEFAULT_SIGMA_CELLS * th
    got = p3m.short_range_tiles(tps, torch.from_numpy(np.array(idx)), EPS2, tsig, trcut, block,
                                torch.from_numpy(np.array(mask))).numpy()
    assert not got[:, 3].any()
    for want in (ref, pal):
        np.testing.assert_allclose(got[:, :3], want, rtol=2e-4, atol=3e-6 * np.abs(want).max())


@pytest.mark.parametrize("block", [64, 128, 256])
def test_dense_slots_hold_every_pair_within_rcut(scene, block):
    """The slots the wrapper flags for the isolated ``short_range`` kernel's
    vote-free loop (``p3m._dense_slots``) hold no pair at or past rcut,
    exactly (f64) and in the kernel's f32 r² = dx·dx + (dy·dy + dz·dz), so
    that loop and the voting one give the same bits; the scene has slots of
    both kinds."""
    pm_np, _, n_real = scene
    _, (tps, tlo, thi, th) = sorted_tiles(pm_np, n_real, 32, block)
    rcut = p3m.DEFAULT_RCUT_SIGMAS * p3m.DEFAULT_SIGMA_CELLS * th
    _, _, idx = p3m._select_neighbors(tlo, thi, th, 8)
    dense = p3m._dense_slots(tps, idx.to(torch.int32), block, rcut).numpy()
    assert dense.dtype == np.uint8 and dense.any() and not dense.all()
    rows = tps[:, :3].reshape(-1, block, 3).numpy()
    rcut2 = np.float32(rcut) * np.float32(rcut)
    for t in range(rows.shape[0]):
        src = rows[idx[t].numpy()[dense[t] != 0]]  # (slots, source, 3)
        d = src[:, None, :, :] - rows[t][None, :, None, :]  # (slots, target, source, 3) f32
        r2 = d[..., 0] * d[..., 0] + (d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
        d64 = src[:, None, :, :].astype(np.float64) - rows[t][None, :, None, :].astype(np.float64)
        assert (r2 < rcut2).all() and ((d64 * d64).sum(-1) < rcut2).all()


def test_sym_jitter_matches_jax():
    """The hash's factors give JAX's jitter; ``u(i, j) == u(j, i)``."""
    ids = np.random.default_rng(3).integers(0, 70000, (2, 500)).astype(np.int32)
    h = np.float32(0.1234)
    u, scale = p3m._sym_jitter_ids(torch.from_numpy(ids[0]), torch.from_numpy(ids[1]), torch.tensor(h))
    u_rev, _ = p3m._sym_jitter_ids(torch.from_numpy(ids[1]), torch.from_numpy(ids[0]), torch.tensor(h))
    want = np.asarray(jp3m._sym_jitter_ids(jnp.asarray(ids[0]), jnp.asarray(ids[1]), jnp.float32(h)))
    np.testing.assert_array_equal((u * scale).numpy(), want)
    assert torch.equal(u, u_rev)


def test_k_short_matches_jax():
    r2 = np.concatenate([[0.0], np.geomspace(1e-8, 10.0, 200)]).astype(np.float32)
    got = p3m.k_short(torch.from_numpy(r2), EPS2, torch.tensor(0.05)).numpy()
    want = np.asarray(jp3m.k_short(jnp.asarray(r2), EPS2, jnp.float32(0.05)))
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("order", [3, 2])
def test_solve_accel_long_matches_jax(scene, order):
    pm_np, _, n_real = scene
    grid = 32
    tpm = torch.from_numpy(pm_np.copy())
    lo, h = pm._box(tpm[:n_real, :3], grid)
    rho = p3m.tsc_deposit(tpm[:, :3], tpm[:, 3], lo, h, grid)
    got = p3m.solve_accel_long(rho, h, EPS2, 1.5 * h, order=order).numpy()
    jh = jnp.float32(float(h))
    want = np.asarray(jp3m.solve_accel_long(jnp.asarray(rho.numpy()), jh, EPS2, 1.5 * jh, order=order))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_accel_p3m_matches_jax(scene, accels):
    pm_np, _, n_real = scene
    got, want, _ = accels
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    assert not got[:, 3].any()


def test_accel_p3m_meets_direct_contract(scene, accels):
    """The JAX package's contract, held by the port on its own: median
    below 2e-3 and p99 below 1e-2 against the direct sum, and the 1e7
    centres within 3e-2 (tests/test_p3m.py)."""
    pm_np, _, n_real = scene
    got, _, direct = accels
    rel = rel_per_body(got[:n_real], direct[:n_real])
    assert np.median(rel) < 2e-3, np.median(rel)
    assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)
    heavy = np.where(pm_np[:n_real, 3] > 1e6)[0]
    assert heavy.size == 2 and rel[heavy].max() < 3e-2


def test_accel_p3m_overflow_matches_jax():
    """Past p3m_bench's probe size (two-galaxy n = 16,384, seed 1) at grid
    128 and k = 32, nearly every tile drops source tiles within rcut, and
    the JAX package's force leaves the contract against the direct sum (n =
    65,536: 246 of 256 tiles overflow, p99 ~2e-2).  The port drops the same
    pairs: its accelerations, its errors against the direct sum on 1,024
    sampled bodies and its overflow count equal JAX's.  Run with ``-s`` to
    see the numbers; the 2M chip run holds the force to what the selection
    asks for instead of the contract."""
    pm_np, _, _ = make_preset("two-galaxy", seed=1, G=G, n=65536)
    pm_np = pm_np.astype(np.float32)
    n_real = pm_np.shape[0]
    kw = dict(grid=128, eps2=EPS2, n_real=n_real, nbr_k=32)
    tpm = torch.from_numpy(pm_np)
    rows = np.random.default_rng(0).choice(n_real, 1024, replace=False)
    got = p3m.accel_p3m(tpm, G, **kw).numpy()[rows]
    want = np.asarray(jp3m.accel_p3m(jnp.asarray(pm_np), G, short_backend="jnp", mesh_backend="jnp", **kw))[rows]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    direct = cf.force_exact_plain(tpm[rows].contiguous(), tpm, G, EPS2).numpy()
    e_got, e_want = rel_per_body(got, direct), rel_per_body(want, direct)
    ov = p3m.p3m_neighbor_overflow(tpm, grid=128, n_real=n_real, nbr_k=32)
    nb = n_real // p3m.p3m_block(n_real)
    print(f"two-galaxy n={n_real} grid 128 k 32: tile overflow {ov} of {nb}; vs direct, port median "
          f"{np.median(e_got):.3e} p99 {np.percentile(e_got, 99):.3e}, JAX median {np.median(e_want):.3e} "
          f"p99 {np.percentile(e_want, 99):.3e}")
    assert ov == int(jp3m.p3m_neighbor_overflow(jnp.asarray(pm_np), grid=128, n_real=n_real, nbr_k=32))
    assert ov > 0.9 * nb
    for q in (50, 99):
        assert abs(np.percentile(e_got, q) / np.percentile(e_want, q) - 1) < 1e-2


def test_accel_p3m_momentum(scene, accels):
    """tests/test_p3m.py::test_momentum's bound: |sum m a| < 1e-4 of sum |m a|."""
    pm_np, _, n_real = scene
    got, _, _ = accels
    m = pm_np[:n_real, 3:4].astype(np.float64)
    ma = m * got[:n_real, :3]
    assert np.all(np.abs(ma.sum(axis=0)) < 1e-4 * np.abs(ma).sum(axis=0))


def test_accel_p3m_plain_backend_matches_kernel_route(scene, accels):
    """``backend="jnp"`` (the twins on any device) is the CPU kernel route."""
    pm_np, _, n_real = scene
    got = p3m.accel_p3m(torch.from_numpy(pm_np), G, grid=32, eps2=EPS2, n_real=n_real, nbr_k=8, block=256,
                        backend="jnp").numpy()
    again = p3m.accel_p3m(torch.from_numpy(pm_np), G, grid=32, eps2=EPS2, n_real=n_real, nbr_k=8,
                          block=256).numpy()
    np.testing.assert_array_equal(got, again)


def test_p3m_step_matches_jax_five_steps():
    """``make_step_fn(method="p3m")`` against the JAX step (``backend="jnp"``)
    from the same state, 5 steps: rtol 1e-4, atol 1e-5 of the max."""
    pm_np, vel_np, n_real = clustered(1000, 1024)
    cfg = dict(method="p3m", pm_grid=32)
    step = make_step_fn(SimConfig(**cfg), 1024, n_real, "cpu")
    jstep = jax_make_step_fn(JaxConfig(backend="jnp", **cfg), 1024, n_real)
    s = SimState(torch.from_numpy(pm_np), torch.from_numpy(vel_np), torch.zeros((1024, 4)), 0)
    js = jax_init_state(pm_np, vel_np, n_pad=1024)
    for _ in range(5):
        s = step(s, 1e-3, G)
        js = jstep(js, 1e-3, G)
    for got, want in ((s.pos_mass, js.pos_mass), (s.vel, js.vel), (s.accel, js.accel)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_cli_run_p3m_on_cpu(capsys, tmp_path):
    reset_launch_counts()
    assert cli.main(["run", "--device", "cpu", "--method", "p3m", "--pm-grid", "32", "--p3m-nbr-k", "16",
                     "--preset", "two-galaxy", "--n", "1000", "--steps", "4", "--log-every", "2",
                     "--diagnostics", "--outdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert sum(line.startswith("step=") for line in out.splitlines()) == 2 and "E=" in out
    sim = Simulation.load(str(tmp_path / "final.npz"), device="cpu")
    assert sim.config.method == "p3m" and sim.config.pm_grid == 32 and sim.config.p3m_nbr_k == 16
    assert sim.step_count == 4 and sim.n_real == 1000 and sim.n_pad == 1024
    assert all(np.isfinite(a).all() for a in sim.arrays())
    assert all(c == 0 for c in launch_counts().values())


@pytest.mark.parametrize(
    "kw,item",
    [
        ({"method": "p3m", "cosmology": "eds", "boundary": "periodic", "box_size": 10.0}, "item 9"),
        ({"method": "pm", "cosmology": "lcdm"}, "queue 1 item 9 (cosmology"),
    ],
)
def test_unported_mesh_configs_raise(kw, item):
    """A cosmology raises when the step is built (ROADMAP queue 1 item 9b).
    The periodic box, forward and backward, runs: tests/test_torch_periodic.py
    and tests/test_torch_periodic_grad.py."""
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(")):
        Simulation.from_preset("uniform-sphere", SimConfig(**kw), n=256, device="cpu")



PLANTED = pair_checks.short_range_scenes(periodic=False)


@pytest.mark.parametrize("name", list(PLANTED))
def test_short_range_twin_on_planted_pairs(name):
    """``pair_checks``' planted pairs (r² one ulp either side of rcut² along
    one axis, a warp with one live lane, masked slots, coincident rows), on
    which the card holds the kernel to this twin and to the parent design
    bit for bit, against the Pallas kernel (interpret mode) and the jnp
    form: rtol 2e-4, atol 3e-6 of the max, the bound above.  The pair one
    ulp inside rcut counts and the one at rcut does not, in both."""
    sc = PLANTED[name]
    ps, idx, mask, block = sc["ps"], sc["nbr_idx"], sc["mask"], sc["block"]
    nb = ps.shape[0] // block
    args = (jnp.asarray(ps), jnp.asarray(idx), 0, nb, sc["eps2"], jnp.float32(sc["sigma"]), jnp.float32(sc["rcut"]),
            block)
    ref = np.asarray(jp3m._short_range_tiles(*args, nbr_mask=jnp.asarray(mask)))
    pal = np.asarray(jp3m._short_range_tiles_pallas(*args, nbr_mask=jnp.asarray(mask), interpret=True))
    got = p3m.short_range_tiles(torch.from_numpy(ps), torch.from_numpy(idx), sc["eps2"], torch.tensor(sc["sigma"]),
                                torch.tensor(sc["rcut"]), block, torch.from_numpy(mask)).numpy()
    assert not got[:, 3].any() and np.isfinite(got).all()
    assert not got[2 * block : 3 * block].any()  # tile 2: every slot masked
    for want in (ref, pal[:, :3]):
        np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=2e-4, atol=3e-6 * np.abs(want).max())
    # Tile 1 alone against tile 0: a row feels its partner where dx² < rcut²
    # in f32: rows 7 and 34 (one ulp inside), not 32 (at rcut) or 33.
    dx = ps[block : 2 * block, 0]
    inside = np.flatnonzero(dx * dx < sc["rcut"] * sc["rcut"]).tolist()
    assert 7 in inside and 34 in inside and 32 not in inside and 33 not in inside and min(inside[1:]) == 34
    one = np.array([[0]] * nb, np.int32)
    keep = np.zeros((nb, 1), np.float32)
    keep[1] = 1.0
    solo = p3m.short_range_tiles(torch.from_numpy(ps), torch.from_numpy(one), sc["eps2"], torch.tensor(sc["sigma"]),
                                 torch.tensor(sc["rcut"]), block, torch.from_numpy(keep)).numpy()
    pal1 = np.asarray(jp3m._short_range_tiles_pallas(*args[:1], jnp.asarray(one), *args[2:], nbr_mask=jnp.asarray(keep),
                                                     interpret=True))
    for out in (solo, pal1):
        x = out[block : 2 * block, 0]
        assert np.flatnonzero(x).tolist() == inside and (x[inside] < 0).all()
