"""The port's sharded direct steps on gloo ranks against the JAX package's
sharded steps (its virtual 8-device CPU mesh) and single-device steps.

Each spawned group of ranks (``parallel.launch.spawn``, 3, 4 or 6 ranks)
runs a list of cases from ``parallel.rank_checks`` once, module-scoped;
rank 0 hands back the gathered states.  Tolerances are
``tests/test_sharded.py``'s: positions after one step rtol 1e-6, atol
1e-7; accelerations rtol 1e-4, atol 1e-6; ten steps rtol 1e-5, atol 1e-6;
diagnostics rtol 1e-5.  Fast mode is held to the MXU emulation of
``tests/test_torch_fast.py`` run on the same schedule (1e-5 of scale).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.ops import diagnostics as jax_diag  # noqa: E402
from nbody3d_tpu.ops.pallas_force import _round_to_bf16_f32  # noqa: E402
from nbody3d_tpu.ops.pallas_force import src_limbs as jax_src_limbs  # noqa: E402
from nbody3d_tpu.ops.step import make_scan_fn, make_step_fn  # noqa: E402
from nbody3d_tpu.parallel import sharded as jax_sharded  # noqa: E402
from nbody3d_tpu.parallel.mesh import default_mesh, grid_mesh  # noqa: E402
from nbody3d_tpu.state import init_state  # noqa: E402
from nbody3d_tpu_torch.parallel.launch import spawn  # noqa: E402
from nbody3d_tpu_torch.parallel.rank_checks import random_bodies, run_cases  # noqa: E402

G = 1e-4
DT = 1e-4
EPS2 = 1e-4

# name -> case; the port's config kwargs are the JAX config's.
CASES4 = {
    "ring": dict(kind="step", config=dict(backend="jnp", strategy="ring"), n=512, seed=0),
    "gather": dict(kind="step", config=dict(backend="jnp", strategy="gather"), n=512, seed=0),
    "ring10": dict(kind="step", config=dict(backend="jnp", strategy="ring"), n=256, seed=1, steps=10),
    "pad": dict(kind="step", config=dict(backend="jnp", strategy="ring"), n=400, n_pad=512, seed=2),
    "diag": dict(kind="diag", n=512, seed=3),
    "ring_exact_kernels": dict(kind="step", config=dict(strategy="ring"), n=256, seed=7),
    "ring_fast_kernels": dict(kind="step", config=dict(strategy="ring", force_mode="fast"), n=256, seed=7),
    "gather_fast_kernels": dict(kind="step", config=dict(strategy="gather", force_mode="fast"), n=256, seed=7),
    "ringsym": dict(kind="step", config=dict(backend="jnp", strategy="ringsym"), n=512, seed=0),
    "ringsym_kernels_pad": dict(kind="step", config=dict(strategy="ring", force_mode="sym", block_target=32),
                                n=400, n_pad=512, seed=2),
    "ringsym_src_chunks": dict(kind="step", config=dict(strategy="ringsym", force_mode="sym", block_target=16),
                               n=512, seed=6, src_chunks=2),
    "ringsym10": dict(kind="step", config=dict(backend="jnp", strategy="ringsym"), n=256, seed=1, steps=10),
    "yoshida4": dict(kind="step", config=dict(backend="jnp", strategy="ring", integrator="yoshida4"), n=512, seed=3),
    "2d": dict(kind="step", config=dict(backend="jnp", strategy="2d"), mesh=(2, 2), n=512, seed=0),
    "2d_fast_kernels_pad": dict(kind="step", config=dict(strategy="2d", force_mode="fast"), mesh=(2, 2), n=400,
                                n_pad=512, seed=2),
    "2d_diag": dict(kind="diag", mesh=(2, 2), n=512, seed=3),
}
CASES3 = {
    "ringsym": dict(kind="step", config=dict(backend="jnp", strategy="ringsym"), n=384, seed=4),
    "ringsym_kernels": dict(kind="step", config=dict(strategy="ringsym", force_mode="sym", block_target=32),
                            n=360, n_pad=384, seed=4),
    "ring_exact_kernels": dict(kind="step", config=dict(strategy="ring"), n=384, seed=4),
}
CASES6 = {
    "2d_2x3": dict(kind="step", config=dict(backend="jnp", strategy="2d"), mesh=(2, 3), n=480, seed=0),
    "2d_3x2": dict(kind="step", config=dict(backend="jnp", strategy="2d"), mesh=(3, 2), n=480, seed=0),
    "2d_3x2_exact_kernels_pad": dict(kind="step", config=dict(strategy="2d"), mesh=(3, 2), n=450, n_pad=480,
                                     seed=5),
    "2d_2x3_fast_kernels": dict(kind="step", config=dict(strategy="2d", force_mode="fast"), mesh=(2, 3), n=480,
                                seed=5),
}


def _run(world, cases):
    names = list(cases)
    out = spawn(run_cases, world, [cases[k] for k in names], device="cpu", timeout=240)
    return dict(zip(names, out[0]))


@pytest.fixture(scope="module")
def d4():
    return _run(4, CASES4)


@pytest.fixture(scope="module")
def d3():
    return _run(3, CASES3)


@pytest.fixture(scope="module")
def d6():
    return _run(6, CASES6)


def jax_state(seed, n, n_pad=None):
    pm, v = random_bodies(seed, n)
    return init_state(pm, v, n_pad=n_pad)


def jax_single(case, steps=None, **over):
    """The JAX package's single-device step(s) on the case's state, by
    default on its plain route."""
    kw = {**case["config"], "backend": "jnp", **over}
    cfg = JaxConfig(**{k: v for k, v in kw.items() if k != "force_mode"})
    n, n_pad = case["n"], case.get("n_pad", case["n"])
    s = jax_state(case["seed"], n, n_pad)
    steps = steps or case.get("steps", 1)
    if steps == 1:
        return make_step_fn(cfg, n_pad, n, "cpu")(s, DT, G)
    return make_scan_fn(make_step_fn(cfg, n_pad, n, "cpu"))(jax.tree.map(jnp.copy, s), DT, G, steps)


def jax_sharded_run(case, world, **over):
    """The JAX package's sharded step(s) on its virtual mesh."""
    cfg = JaxConfig(**{**case["config"], **over})
    n, n_pad = case["n"], case.get("n_pad", case["n"])
    spec = case.get("mesh", "x")
    mesh = default_mesh(world) if spec == "x" else grid_mesh(*spec, n_devices=world)
    s = jax_sharded.shard_state(jax_state(case["seed"], n, n_pad), mesh, "x" if spec == "x" else None)
    step = jax_sharded.make_sharded_step(cfg, n_pad, n, mesh, "cpu")
    steps = case.get("steps", 1)
    if steps == 1:
        return jax.jit(step)(s, DT, G)
    return make_scan_fn(step)(s, DT, G, steps)


def assert_step(got, want, pos=(1e-6, 1e-7), acc=(1e-4, 1e-6), n=None):
    p, _, a, _ = got
    rows = slice(None) if n is None else slice(0, n)
    np.testing.assert_allclose(p[rows], np.asarray(want.pos_mass)[rows], rtol=pos[0], atol=pos[1])
    if acc is not None:
        np.testing.assert_allclose(a[rows], np.asarray(want.accel)[rows], rtol=acc[0], atol=acc[1])


# ------------------------------------------------- mxu emulation (fast)
def mxu_emulation(tgt, src, diag):
    """``tests/test_torch_fast.py``'s emulation of the MXU's fast force of
    ``src`` on ``tgt``: JAX's limbs and weights rounded to bf16, the self
    pairs of ``diag = (off, lo, hi)`` zeroed, the f32 epilogue.  The
    products of bf16 values are summed exactly and rounded once (an f32
    sum in one order carries ~1e-5 of scale of its own on these scenes),
    so that the comparison sees the schedule's hops, diagonals and sums."""
    off, lo, hi = diag
    s16 = np.asarray(jax_src_limbs(jnp.asarray(src), G)).astype(ml_dtypes.bfloat16).astype(np.float32)
    tj, sj = jnp.asarray(tgt), jnp.asarray(src)
    dx, dy, dz = (sj[None, :, c] - tj[:, None, c] for c in range(3))
    d2 = dx * dx + (dy * dy + (dz * dz + EPS2))
    w = np.asarray(_round_to_bf16_f32(jax.lax.rsqrt(d2 * (d2 * d2))))
    rows = np.arange(tgt.shape[0])[:, None]
    cols = np.arange(src.shape[0])[None, :]
    w = np.where((cols - rows == off) & (rows >= lo) & (rows < hi), np.float32(0), w)
    a = (w.astype(np.float64) @ s16.astype(np.float64)).astype(np.float32)
    s = a[:, 9] + a[:, 10] + a[:, 11]
    return np.stack([a[:, 3 * c] + a[:, 3 * c + 1] + a[:, 3 * c + 2] - tgt[:, c] * s for c in range(3)], axis=1)


def emulated_schedule(case, world):
    """The fast force of the case's sharded schedule, every hop or tile
    emulated as the MXU would run it and the parts summed in f32 as the
    step sums them (hop by hop; the 2-D tiles over c)."""
    n, n_pad = case["n"], case.get("n_pad", case["n"])
    pm, _ = random_bodies(case["seed"], n)
    full = np.zeros((n_pad, 4), np.float32)
    full[:n] = pm
    m = n_pad // world
    shards = [full[i * m : (i + 1) * m] for i in range(world)]
    no_diag = (1 << 30, 0, 1 << 30)
    strategy = case["config"]["strategy"]
    if strategy == "gather":
        return np.concatenate([mxu_emulation(shards[i], full, (i * m, 0, 1 << 30)) for i in range(world)])
    if strategy == "ring":
        out = []
        for i in range(world):
            acc = np.zeros((m, 3), np.float32)
            for k in range(world):
                acc = acc + mxu_emulation(shards[i], shards[(i - k) % world], (0, 0, 1 << 30) if k == 0 else no_diag)
            out.append(acc)
        return np.concatenate(out)
    nrows, ncols = case["mesh"]
    seg = ncols * m
    out = np.zeros((n_pad, 3), np.float32)
    for r in range(nrows):
        for c in range(ncols):
            src = np.concatenate([shards[i * ncols + c] for i in range(nrows)])
            out[r * seg : (r + 1) * seg] += mxu_emulation(full[r * seg : (r + 1) * seg], src,
                                                          ((r - c) * m, c * m, (c + 1) * m))
    return out


def assert_fast(got, case, world):
    """The stored acceleration (the force at the start) within 1e-5 of
    scale of the emulated schedule."""
    n = case["n"]
    want = emulated_schedule(case, world)[:n]
    assert np.abs(got[2][:n, :3] - want).max() / np.abs(want).max() < 1e-5


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("name", ["ring", "gather", "ringsym"])
def test_step_matches_jax_sharded_and_single_device(d4, name):
    case = CASES4[name]
    assert_step(d4[name], jax_single(case))
    assert_step(d4[name], jax_sharded_run(case, 4))
    assert d4[name][3] == 1


@pytest.mark.parametrize("name", ["ring10", "ringsym10"])
def test_ten_step_trajectory(d4, name):
    case = CASES4[name]
    assert_step(d4[name], jax_single(case), pos=(1e-5, 1e-6), acc=None)
    assert_step(d4[name], jax_sharded_run(case, 4), pos=(1e-5, 1e-6), acc=None)
    assert d4[name][3] == 10


def test_padding_freezes_padded_rows(d4):
    case = CASES4["pad"]
    got = d4["pad"]
    assert_step(got, jax_single(case))
    assert_step(got, jax_sharded_run(case, 4))
    for t in got[:3]:
        np.testing.assert_array_equal(t[400:], 0.0)


@pytest.mark.parametrize("name", ["diag", "2d_diag"])
def test_sharded_diagnostics(d4, name):
    case = CASES4[name]
    ke, pe, total, mom, ang, mass = d4[name]
    s = jax_state(case["seed"], case["n"])
    d0 = jax_diag.compute(s.pos_mass, s.vel, G, eps2=EPS2)
    np.testing.assert_allclose(ke, float(d0.kinetic), rtol=1e-5)
    np.testing.assert_allclose(pe, float(d0.potential), rtol=1e-5)
    np.testing.assert_allclose(total, float(d0.total_energy), rtol=1e-5)
    np.testing.assert_allclose(mom, np.asarray(d0.momentum), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ang, np.asarray(d0.angular_momentum), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mass, float(d0.total_mass), rtol=1e-6)
    spec = case.get("mesh", "x")
    mesh = default_mesh(4) if spec == "x" else grid_mesh(*spec, n_devices=4)
    dj = jax_sharded.make_sharded_diagnostics(JaxConfig(), case["n"], mesh)(
        jax_sharded.shard_state(s, mesh, "x" if spec == "x" else None), G)
    np.testing.assert_allclose(pe, float(dj.potential), rtol=1e-5)
    np.testing.assert_allclose(ke, float(dj.kinetic), rtol=1e-5)


def test_kernel_route_ring_exact(d4):
    """The kernel route (``force_exact``'s twin a hop) against the JAX
    package's ring on its Pallas kernel (interpret) and its oracle."""
    case = CASES4["ring_exact_kernels"]
    got = d4["ring_exact_kernels"]
    assert_step(got, jax_single(case))
    assert_step(got, jax_sharded_run(case, 4, backend="pallas", block_target=32, block_source=32))


@pytest.mark.parametrize("name", ["ring_fast_kernels", "gather_fast_kernels", "2d_fast_kernels_pad"])
def test_kernel_route_fast_matches_mxu_emulation(d4, name):
    """Fast mode through the ring (``force_fast`` a hop, its diagonal
    ``SELF_DIAG`` at hop 0 and ``NO_DIAG`` after), the gather (diagonal
    ``my*shard``) and the 2-D grid (the restricted diagonal) against the
    MXU emulation of the same schedule (each hop's epilogue rounds on its
    own); the positions against the JAX sharded fast step's."""
    case = CASES4[name]
    assert_fast(d4[name], case, 4)
    want = jax_sharded_run(case, 4, backend="pallas", block_target=32, block_source=32)
    n = case["n"]
    np.testing.assert_allclose(d4[name][0][:n], np.asarray(want.pos_mass)[:n], rtol=1e-5, atol=1e-6)


def test_kernel_route_ringsym_with_padding(d4):
    """ringsym (``force_mode="sym"`` on a ring) on the kernel route: the
    sym chain's twins at hop 0, ``pair_sym``'s after, the shared half-hop
    of D = 4; padded rows frozen."""
    case = CASES4["ringsym_kernels_pad"]
    got = d4["ringsym_kernels_pad"]
    assert_step(got, jax_single(case), n=400)
    for t in got[:3]:
        np.testing.assert_array_equal(t[400:], 0.0)


def test_ringsym_source_chunked_pair_hops(d4, monkeypatch):
    """Two source chunks a pair hop (``src_chunks=2``) against the oracle
    and the JAX package's chunked half ring (its ``SYM_MAX_N`` patched to
    force two chunks, as ``tests/test_sharded.py`` does)."""
    case = CASES4["ringsym_src_chunks"]
    got = d4["ringsym_src_chunks"]
    assert_step(got, jax_single(case))
    monkeypatch.setattr(jax_sharded, "SYM_MAX_N", 32)
    assert_step(got, jax_sharded_run(case, 4, backend="pallas", block_source=16))


def test_yoshida4_through_the_ring(d4):
    case = CASES4["yoshida4"]
    got = d4["yoshida4"]
    for want in (jax_single(case), jax_sharded_run(case, 4)):
        assert_step(got, want, acc=None)
        np.testing.assert_allclose(got[1], np.asarray(want.vel), rtol=1e-5, atol=1e-7)


def test_grid2d_square(d4):
    case = CASES4["2d"]
    assert_step(d4["2d"], jax_single(case, strategy="ring"))
    assert_step(d4["2d"], jax_sharded_run(case, 4))


@pytest.mark.parametrize("name", ["2d_2x3", "2d_3x2"])
def test_grid2d_non_square(d6, name):
    """2 x 3 and 3 x 2: a row/column swap in the gathers, the diagonal or
    the reduce-scatter would fail one of them."""
    case = CASES6[name]
    assert_step(d6[name], jax_single(case, strategy="ring"))
    assert_step(d6[name], jax_sharded_run(case, 6))


def test_grid2d_non_square_kernel_routes(d6):
    case = CASES6["2d_3x2_exact_kernels_pad"]
    got = d6["2d_3x2_exact_kernels_pad"]
    assert_step(got, jax_single(case, strategy="ring"), n=450)
    np.testing.assert_array_equal(got[0][450:], 0.0)
    assert_fast(d6["2d_2x3_fast_kernels"], CASES6["2d_2x3_fast_kernels"], 6)


@pytest.mark.parametrize("name", ["ringsym", "ringsym_kernels", "ring_exact_kernels"])
def test_odd_device_count(d3, name):
    """D = 3: ringsym has no shared half-hop (one pair hop covers every
    pair); the ring's hops 1 and 2 run without a diagonal."""
    case = CASES3[name]
    n = case["n"]
    assert_step(d3[name], jax_single(case), n=n)
    if name == "ringsym":
        assert_step(d3[name], jax_sharded_run(case, 3))
