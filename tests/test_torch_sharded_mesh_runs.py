"""The port's sharded mesh steps in the configurations that compose with
them, on 4 gloo ranks against the JAX package's sharded steps on its
virtual mesh with the same D: yoshida4 through PM and P3M
(``tests/test_sharded.py:318-342``), P3M on the 2 x 2 grid, flattened
row-major (``tests/test_p3m.py:635``), the comoving EdS step with PM and
P3M on a Zel'dovich box (``tests/test_expansion.py:264-290``), and the
halo-starvation property of ``tests/test_p3m_distributed.py:84``.

One group of ranks runs the cases once, module-scoped.  Bounds: positions
rtol 1e-6, atol 1e-7; accelerations rtol 1e-4, atol 1e-5 of the max;
velocities rtol 1e-5 (the JAX yoshida4 test's).  Every case pads.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.ops.step import make_scan_fn, make_step_fn  # noqa: E402
from nbody3d_tpu.parallel import sharded as jax_sharded  # noqa: E402
from nbody3d_tpu.parallel.mesh import default_mesh, grid_mesh  # noqa: E402
from nbody3d_tpu.state import init_state  # noqa: E402
from nbody3d_tpu_torch.parallel.launch import spawn  # noqa: E402
from nbody3d_tpu_torch.parallel.rank_checks import case_bodies, run_cases  # noqa: E402

G, DT, D = 1e-4, 1e-4, 4
BOX, G_N, MASS = 10.0, 1e-4, 30.0


def _eds_dt(n1: int) -> float:
    """``tests/test_expansion.py``'s step: 2% of the EdS starting time."""
    rho_bar = MASS * n1**3 / BOX**3
    t_i = 2.0 / (3.0 * np.sqrt(8.0 * np.pi / 3.0 * G_N * rho_bar))
    return float(t_i * 0.02)


COSMO = dict(backend="jnp", boundary="periodic", box_size=BOX, pm_grid=16, G=G_N, cosmology="eds")
ZEL = dict(bodies="zeldovich", n1=16, box=BOX, G=G_N, dt=_eds_dt(16), seed=11, n_pad=4352, steps=2)
HALO = dict(method="p3m", pm_grid=32, backend="jnp", p3m_heavy_k=0)
CASES = {
    "y4_pm": dict(kind="step", config=dict(method="pm", backend="jnp", pm_grid=16, integrator="yoshida4"),
                  n=500, n_pad=512, seed=3),
    "y4_p3m": dict(kind="step", config=dict(method="p3m", backend="jnp", pm_grid=16, integrator="yoshida4"),
                   n=500, n_pad=512, seed=3),
    "p3m_2x2": dict(kind="step", config=dict(method="p3m", backend="jnp", pm_grid=32, strategy="2d", p3m_block=64,
                                             p3m_nbr_k=8),
                    mesh=(2, 2), bodies="clustered", n=1000, n_pad=1024, seed=3),
    "cosmo_pm": dict(kind="step", config=dict(COSMO, method="pm"), **ZEL),
    "cosmo_p3m": dict(kind="step", config=dict(COSMO, method="p3m", p3m_nbr_k=16), **ZEL),
    "halo_starved": dict(kind="step", config=dict(HALO, p3m_halo_tiles=1), bodies="clustered", n=2048, n_pad=4096,
                         seed=3),
    "halo_full": dict(kind="step", config=HALO, bodies="clustered", n=2048, n_pad=4096, seed=3),
}


@pytest.fixture(scope="module")
def d4():
    names = list(CASES)
    out = spawn(run_cases, D, [CASES[k] for k in names], device="cpu", timeout=300)
    return dict(zip(names, out[0]))


def jax_state(case):
    pm, v = case_bodies(case)
    return init_state(pm, v, n_pad=case.get("n_pad", pm.shape[0])), pm.shape[0]


def jax_run(case, sharded=True):
    """The JAX package's step(s) on the case's state: sharded on its
    virtual mesh of D devices, or on one device."""
    cfg = JaxConfig(**case["config"])
    s, n = jax_state(case)
    n_pad = s.pos_mass.shape[0]
    dt, g = case.get("dt", DT), case.get("G", G)
    if sharded:
        spec = case.get("mesh", "x")
        mesh = default_mesh(D) if spec == "x" else grid_mesh(*spec, n_devices=D)
        s = jax_sharded.shard_state(s, mesh, "x" if spec == "x" else None)
        step = jax_sharded.make_sharded_step(cfg, n_pad, n, mesh, "cpu")
    else:
        step = make_step_fn(cfg, n_pad, n, "cpu")
    steps = case.get("steps", 1)
    if steps == 1:
        return jax.jit(step)(s, dt, g)
    return make_scan_fn(step)(s, dt, g, steps)


def assert_state(got, want, n, vel=None):
    p, v, a, _ = got
    np.testing.assert_allclose(p[:n], np.asarray(want.pos_mass)[:n], rtol=1e-6, atol=1e-7)
    w = np.asarray(want.accel)[:n]
    np.testing.assert_allclose(a[:n], w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
    if vel is not None:
        np.testing.assert_allclose(v[:n], np.asarray(want.vel)[:n], rtol=vel, atol=1e-7)
    for t in got[:3]:
        np.testing.assert_array_equal(t[n:], 0.0)


@pytest.mark.parametrize("name", ["y4_pm", "y4_p3m"])
def test_yoshida4_reruns_the_exchange(d4, name):
    """yoshida4's three force evaluations each run the whole schedule:
    against the JAX sharded step and the JAX single-device step."""
    case = CASES[name]
    for want in (jax_run(case), jax_run(case, sharded=False)):
        assert_state(d4[name], want, case["n"], vel=1e-5)


def test_p3m_on_the_2x2_grid(d4):
    """P3M on a 2 x 2 mesh shards over both axes, row-major: the JAX
    package's 2-D sharded step and its single-device step."""
    case = CASES["p3m_2x2"]
    for want in (jax_run(case), jax_run(case, sharded=False)):
        assert_state(d4["p3m_2x2"], want, case["n"])


@pytest.mark.parametrize("name", ["cosmo_pm", "cosmo_p3m"])
def test_comoving_eds_on_the_mesh(d4, name):
    """Two comoving EdS steps (``rho_bar`` from the mass summed over the
    ranks) of a 16³ Zel'dovich box against the JAX sharded step."""
    case = CASES[name]
    got = d4[name]
    assert_state(got, jax_run(case), 16**3, vel=1e-5)
    assert got[3] == 2


def test_halo_starvation_keeps_momentum(d4):
    """One halo tile a rank (``p3m_halo_tiles=1``, no heavy split): a pair
    whose remote tile fell out of either rank's halo is dropped on both
    sides, so the net kick stays at f32 reduction level; and the budget
    bites (the step differs from the unstarved one, which matches JAX's)."""
    case = CASES["halo_starved"]
    n = case["n"]
    pm, _ = case_bodies(case)
    a = d4["halo_starved"][2][:n, :3].astype(np.float64)
    m = pm[:, 3:4].astype(np.float64)
    kick = np.abs((m * a).sum(axis=0))
    scale = np.abs(m * a).sum(axis=0).max()
    assert kick.max() / scale < 1e-5, (kick, scale)
    assert not np.array_equal(d4["halo_starved"][2], d4["halo_full"][2])
    assert_state(d4["halo_starved"], jax_run(case), n)
    assert_state(d4["halo_full"], jax_run(CASES["halo_full"]), n)
