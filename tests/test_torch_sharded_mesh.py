"""The port's sharded PM and P3M steps on 4 gloo ranks against the JAX
package's sharded steps on its virtual mesh with the same D = 4
(``default_mesh(4)``), so that the tiling and the halo are the same.

One group of ranks (``parallel.launch.spawn``) runs the cases of
``parallel.rank_checks`` once, module-scoped.  Bounds: the integer stages
(splitters, destinations, each rank's sorted gids, halo tiles, neighbour
lists and final mask) bit-equal to the JAX package's ``exchange.py`` and
selection run under ``jax.shard_map``; positions rtol 1e-6, atol 1e-7;
accelerations rtol 1e-4, atol 1e-5 of the max (the port's P3M bounds).
The in-process replay of the 4 ranks (``exchange.ReplayGroup``, what
``chip_smoke.py`` phase 18a runs on the card) equals the ranks' force bit
for bit.  Every case pads (``n_real < n_pad``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
import nbody3d_tpu.ops.pm as jpm  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.ops.ewald import wrap_box as jax_wrap_box  # noqa: E402
from nbody3d_tpu.ops.morton import morton_keys_box as jax_morton_keys_box  # noqa: E402
from nbody3d_tpu.ops.step import fit_block, make_scan_fn  # noqa: E402
from nbody3d_tpu.parallel import exchange as jex  # noqa: E402
from nbody3d_tpu.parallel import sharded as jax_sharded  # noqa: E402
from nbody3d_tpu.parallel.mesh import default_mesh, grid_mesh  # noqa: E402
from nbody3d_tpu.state import init_state  # noqa: E402
from nbody3d_tpu_torch.parallel.launch import spawn  # noqa: E402
from nbody3d_tpu_torch.parallel.rank_checks import case_bodies, run_cases  # noqa: E402

G = 1e-4
DT = 1e-4
D = 4

P3M_ISO = dict(method="p3m", backend="jnp", pm_grid=32, p3m_block=64, p3m_nbr_k=8)
P3M_BOX = dict(P3M_ISO, boundary="periodic", box_size=8.0, mesh_interlace=True)
CASES = {
    "pm_iso": dict(kind="step", config=dict(method="pm", backend="jnp", pm_grid=16), n=1000, n_pad=1024, seed=0),
    "pm_box": dict(kind="step", config=dict(method="pm", backend="jnp", pm_grid=16, boundary="periodic",
                                            box_size=4.0, mesh_interlace=True), n=1000, n_pad=1024, seed=1),
    "p3m_iso": dict(kind="step", config=P3M_ISO, bodies="clustered", n=2000, n_pad=2048, seed=3),
    "p3m_box": dict(kind="step", config=P3M_BOX, n=2000, n_pad=2048, seed=4),
    "p3m_iso_stages": dict(kind="p3m_stages", config=P3M_ISO, bodies="clustered", n=2000, n_pad=2048, seed=3),
    "p3m_box_stages": dict(kind="p3m_stages", config=P3M_BOX, n=2000, n_pad=2048, seed=4),
    "replay_p3m_iso": dict(kind="replay", config=P3M_ISO, bodies="clustered", n=2000, n_pad=2048, seed=3),
    "replay_p3m_box": dict(kind="replay", config=P3M_BOX, n=2000, n_pad=2048, seed=4),
    "replay_pm_box": dict(kind="replay", config=dict(method="pm", backend="jnp", pm_grid=16, boundary="periodic",
                                                     box_size=4.0, mesh_interlace=True), n=1000, n_pad=1024, seed=1),
    "replay_p3m_kernels": dict(kind="replay", config=dict(P3M_ISO, backend="auto"), bodies="clustered", n=2000,
                               n_pad=2048, seed=3),
}


@pytest.fixture(scope="module")
def d4():
    names = list(CASES)
    out = spawn(run_cases, D, [CASES[k] for k in names], device="cpu", timeout=300)
    return {k: [out[r][i] for r in range(D)] for i, k in enumerate(names)}


def jax_config(case):
    return JaxConfig(**case["config"])


def jax_state(case):
    pm, v = case_bodies(case)
    return init_state(pm, v, n_pad=case.get("n_pad", pm.shape[0])), pm.shape[0]


def jax_sharded_run(case, dt=DT, g=G):
    """The JAX package's sharded step(s) on its virtual mesh of D devices."""
    spec = case.get("mesh", "x")
    mesh = default_mesh(D) if spec == "x" else grid_mesh(*spec, n_devices=D)
    s, n = jax_state(case)
    s = jax_sharded.shard_state(s, mesh, "x" if spec == "x" else None)
    step = jax_sharded.make_sharded_step(jax_config(case), s.pos_mass.shape[0], n, mesh, "cpu")
    steps = case.get("steps", 1)
    if steps == 1:
        return jax.jit(step)(s, dt, g)
    return make_scan_fn(step)(s, dt, g, steps)


def assert_state(got, want, n, acc=True):
    p, _, a, _ = got
    np.testing.assert_allclose(p[:n], np.asarray(want.pos_mass)[:n], rtol=1e-6, atol=1e-7)
    if acc:
        w = np.asarray(want.accel)[:n]
        np.testing.assert_allclose(a[:n], w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
    for t in got[:3]:
        np.testing.assert_array_equal(t[n:], 0.0)


@pytest.mark.parametrize("name", ["pm_iso", "pm_box", "p3m_iso", "p3m_box"])
def test_step_matches_jax_sharded(d4, name):
    """PM (isolated; periodic interlaced) and P3M (isolated with a 1e7 body
    and the heavy split; periodic interlaced) one step on 4 ranks."""
    case = CASES[name]
    got = d4[name][0]
    assert_state(got, jax_sharded_run(case), case["n"])
    assert got[3] == 1


# ------------------------------------------------------ integer stages
def jax_p3m_stages(case):
    """The JAX sharded P3M step's integer stages, run under ``jax.shard_map``
    from the JAX package's own functions (``parallel/exchange.py``, the
    selection and the mask; the halo lines of ``make_p3m_sharded_step``):
    per rank the splitters, destinations, sorted gids, halo tiles,
    neighbour lists and final mask."""
    cfg = jax_config(case)
    s, n = jax_state(case)
    n_pad = s.pos_mass.shape[0]
    shard = n_pad // D
    block = fit_block(shard, jp3m.p3m_block(n_pad, cfg.p3m_block))
    nb, periodic = n_pad // block, cfg.boundary == "periodic"
    tiles_per, nbr_k = nb // D, min(cfg.p3m_nbr_k, nb)
    h_cap = max(1, min(max(2 * tiles_per, 4 * nbr_k, 64), max(nb - tiles_per, 1)))
    perm = [(i, (i + 1) % D) for i in range(D)]
    grid = cfg.pm_grid

    def local(pos_mass):
        my = lax.axis_index("x")
        gid = jnp.arange(shard, dtype=jnp.int32) + my * shard
        validf = (gid < n)[:, None]
        pos = pos_mass[:, :3]
        if periodic:
            L = jnp.float32(cfg.box_size)
            h = L / grid
            pos = jax_wrap_box(pos, L)
        big = jnp.float32(3.0e38)
        lo_w = lax.pmin(jnp.min(jnp.where(validf, pos, big), axis=0), "x")
        hi_w = lax.pmax(jnp.max(jnp.where(validf, pos, -big), axis=0), "x")
        if not periodic:
            _, h = jpm.box_from_bounds(lo_w, hi_w, grid)
        keys = jax_morton_keys_box(pos, lo_w, hi_w, validf[:, 0])
        K, Gs = jex.select_splitters(keys, gid, shard, D, n_pad, "x")
        dest = jex.destinations(keys, gid, K, Gs)
        pm_k = jnp.concatenate([pos, pos_mass[:, 3:4]], axis=1)
        ps, gid_s = jex.exchange_to_sorted(pm_k, gid, keys, (K, Gs), my, D, "x", perm)
        xyz_t = ps[:, :3].reshape(tiles_per, block, 3)
        valid_s = (my * shard + jnp.arange(shard, dtype=jnp.int32) < n).reshape(tiles_per, block, 1)
        lo_b = lax.all_gather(jnp.min(jnp.where(valid_s, xyz_t, jnp.inf), axis=1), "x", axis=0, tiled=True)
        hi_b = lax.all_gather(jnp.max(jnp.where(valid_s, xyz_t, -jnp.inf), axis=1), "x", axis=0, tiled=True)
        kth, neg, nbr_idx = jp3m._select_neighbors(lo_b, hi_b, my * tiles_per, tiles_per, h, nbr_k,
                                                  L=L if periodic else None)
        nbr_mask = jp3m.mutual_neighbor_mask(neg, nbr_idx, lax.all_gather(kth, "x", axis=0, tiled=True))
        # make_p3m_sharded_step's halo (nbody3d_tpu/parallel/sharded.py:964-994).
        owner = nbr_idx // tiles_per
        cross = owner != my
        score = jnp.full((nb,), -jnp.inf, jnp.float32).at[nbr_idx.reshape(-1)].max(
            jnp.where(cross, neg, -jnp.inf).reshape(-1))
        halo_score, halo_ids = lax.top_k(score, h_cap)
        halo_ids = jnp.where(halo_score > -jnp.inf, halo_ids, jnp.int32(nb))
        halo_all = lax.all_gather(halo_ids, "x", axis=0, tiled=False)
        in_halo = jnp.zeros((D, nb + 1), jnp.bool_).at[
            jnp.repeat(jnp.arange(D, dtype=jnp.int32), h_cap), halo_all.reshape(-1)].set(True)
        my_in = lax.dynamic_index_in_dim(in_halo, my, 0, keepdims=False)
        i_tile = my * tiles_per + lax.broadcasted_iota(jnp.int32, nbr_idx.shape, 0)
        halo_ok = jnp.where(cross, my_in[nbr_idx] & in_halo[owner, i_tile], True)
        final = nbr_mask * halo_ok.astype(jnp.float32)
        return K[None], Gs[None], dest, gid_s, halo_ids[None], nbr_idx, final

    spec = P("x")
    mesh = default_mesh(D)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("x", None),), out_specs=(spec,) * 7,
                               check_vma=False))
    outs = [np.asarray(o) for o in fn(jax_sharded.shard_state(s, mesh, "x").pos_mass)]
    names = ("K", "Gs", "dest", "gid_s", "halo_ids", "nbr_idx", "final_mask")
    return [{k: o.reshape((D, -1) + o.shape[1:])[r] for k, o in zip(names, outs)} for r in range(D)]


@pytest.mark.parametrize("name", ["p3m_iso_stages", "p3m_box_stages"])
def test_integer_stages_match_jax_exchange(d4, name):
    """The splitters (the same on every rank), each rank's destinations,
    sorted gids, halo tiles, neighbour lists and final mask, bit-equal to
    the JAX package's stages on the same D; and the gids are the global
    stable (key, gid) sort's slices."""
    want = jax_p3m_stages(CASES[name])
    for r in range(D):
        got = d4[name][r]
        for k in ("K", "Gs", "dest", "gid_s", "halo_ids", "nbr_idx", "final_mask"):
            np.testing.assert_array_equal(got[k].reshape(want[r][k].shape), want[r][k], err_msg=f"rank {r} {k}")
        assert 0 < got["demand"]
    gids = np.concatenate([d4[name][r]["gid_s"] for r in range(D)])
    np.testing.assert_array_equal(np.sort(gids), np.arange(gids.size))
    dest = np.concatenate([d4[name][r]["dest"] for r in range(D)])
    np.testing.assert_array_equal(dest[gids], np.arange(gids.size) // (gids.size // D))


# ---------------------------------------------------------------- replay
@pytest.mark.parametrize("name", ["replay_p3m_iso", "replay_p3m_box", "replay_pm_box", "replay_p3m_kernels"])
def test_replay_equals_the_ranks_bit_for_bit(d4, name):
    """``chip_smoke.py`` phase 18a's replay of the 4 ranks in one process
    (``ReplayGroup``: the collectives as sums and concatenations over a
    list) gives the gloo ranks' force bit for bit, on the plain route and on
    the kernel route's twins."""
    out = d4[name][0]
    np.testing.assert_array_equal(out["replay"], out["ranks"])
    assert np.isfinite(out["ranks"]).all() and np.abs(out["ranks"]).max() > 0
