"""The unfused Newton-3 ("sym") route: the port's sym force ``accel_sym``
(the plain twins of ``sym_diag_prep``/``sym_diag`` -> ``sym_hops`` ->
``sym_combine``, what the wrappers run on CPU tensors) against the JAX
package's ``accel_sym_pallas`` in interpret mode, both ``center`` values;
and the steps it carries (euler, yoshida4, ``fuse_epilogue=False``, one
tile) through ``make_step_fn``, ``Simulation`` and the CLI against the JAX
package's.

Bounds are the JAX package's own (``tests/test_sym.py``): sym force
against the Pallas sym force and the oracle max-abs/scale < 2e-5 (:56),
fused against unfused accel < 5e-5 and p, v within 1e-6 (:455), gradients
max-abs/scale < 1e-5 (:527).  Both sides are f32 with different summation
orders; the port's diagonal and combine twins are compared with the JAX
accumulators folded by ``_combine16``."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.ops.force_jnp import accel_direct as jax_accel_direct  # noqa: E402
from nbody3d_tpu.ops.pallas_force import _combine16, accel_sym_pallas  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import SimState as JaxState  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops.launch import KERNELS, launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

G, EPS2, DT = 1e-4, 1e-4, 1e-3

# (n_pad, tile, n_real): nt = 1, 2, 3 (odd), 4 (even), padded and unpadded.
CASES = [(128, 128, 128), (128, 128, 100), (256, 128, 256), (384, 128, 300),
         (512, 128, 512), (512, 128, 500)]


def bodies(rng, n, n_real, heavy=True):
    """``tests/test_torch_sym.py``'s bodies: a 1e7 body among light ones;
    padded rows (from ``n_real`` on) keep their positions with mass 0."""
    pm = np.concatenate(
        [rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    if heavy:
        pm[0, 3] = 1e7
    pm[n_real:, 3] = 0.0
    return pm


def state(rng, n, n_real):
    pm = bodies(rng, n, n_real, heavy=False)
    vel = np.concatenate([rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1).astype(np.float32)
    vel[n_real:] = 0.0
    return pm, vel


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------- the force
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n,b,n_real", CASES)
def test_accel_sym_matches_jax_sym_force(rng, n, b, n_real, center):
    """Every row, padding included: a padded row (mass 0) carries the pull
    of the real bodies on it in both packages; neither combine zeroes it."""
    pm = bodies(rng, n, n_real)
    got = cf.accel_sym(torch.from_numpy(pm), G, eps2=EPS2, b=b, center=center).numpy()
    want = np.asarray(accel_sym_pallas(jnp.asarray(pm), G, eps2=EPS2, block=b, interpret=True, center=center))
    oracle = np.asarray(jax_accel_direct(jnp.asarray(pm), G, eps2=EPS2))
    assert rel(got, want) < 2e-5
    assert rel(got[:n_real], oracle[:n_real]) < 2e-5
    assert not got[:, 3].any()
    if n_real < n:
        assert np.abs(got[n_real:, :3]).min() > 0 and np.abs(want[n_real:, :3]).min() > 0


@pytest.mark.parametrize("n,b,n_real", [(128, 128, 100), (384, 128, 300), (512, 128, 512)])
def test_sym_diag_twins_match_jax_diagonal(rng, n, b, n_real):
    """The in-tile pass alone.  A tile run through ``accel_sym_pallas`` on
    its own (nt = 1: no hops) gives the JAX diagonal kernel's accumulator
    for that tile, folded by ``_combine16``; both of the port's diagonal
    twins match it for both ``center`` values, and they equal each other
    bit for bit on the same source rows."""
    pm = bodies(rng, n, n_real)
    t_pm = torch.from_numpy(pm)
    src, acc_prep = cf.sym_diag_prep(t_pm, G, EPS2, b)
    assert torch.equal(src, cf.sym_source_rows(t_pm, G))
    acc_diag = cf.sym_diag(src, EPS2, b)
    assert torch.equal(acc_diag, acc_prep)
    for center in (True, False):
        want = np.concatenate([
            np.asarray(_combine16(
                accel_sym_pallas(jnp.asarray(pm[i : i + b]), G, eps2=EPS2, block=b, interpret=True,
                                 raw=True, center=center),
                jnp.asarray(pm[i : i + b]),
            ))
            for i in range(0, n, b)
        ])
        assert rel(acc_diag.numpy(), want) < 2e-5


@pytest.mark.parametrize("n,b,n_real", [(128, 128, 128), (384, 128, 300), (512, 128, 500)])
def test_sym_combine_twin_matches_jax_fold(rng, n, b, n_real):
    """``sym_combine``'s twin on the port's accumulators against the JAX
    package's raw (N, 16) accumulator folded by ``_combine16``; the twin is
    the plain adds with w lane 0 on every row, and the wrapper takes it on
    CPU tensors."""
    pm = bodies(rng, n, n_real)
    src, acc_d = cf.sym_diag_prep(torch.from_numpy(pm), G, EPS2, b)
    acc_h = cf.sym_hops(src, EPS2, b)
    got = cf.sym_combine_plain(acc_d, acc_h)
    assert torch.equal(cf.sym_combine(acc_d, acc_h), got)
    assert torch.equal(got[:, :3], acc_d[:, :3] + acc_h[:, :3]) and not got[:, 3].any()
    raw = accel_sym_pallas(jnp.asarray(pm), G, eps2=EPS2, block=b, interpret=True, raw=True)
    assert rel(got.numpy(), _combine16(raw, jnp.asarray(pm))) < 2e-5


def test_one_tile_has_no_hop_launch(rng):
    pm = torch.from_numpy(bodies(rng, 256, 256))
    src = cf.sym_source_rows(pm, G)
    assert not cf.sym_hops(src, EPS2, 256).any()
    assert torch.equal(cf.accel_sym(pm, G, eps2=EPS2, b=256), cf.sym_diag(src, EPS2, 256))


def test_sym_wrappers_check_input(rng):
    pm = torch.from_numpy(bodies(rng, 256, 256))
    with pytest.raises(ValueError, match="must divide"):
        cf.sym_diag(pm, EPS2, 100)
    with pytest.raises(ValueError, match="one shape"):
        cf.sym_combine(pm, pm[:128].clone())
    with pytest.raises(RuntimeError, match="never take such tensors"):
        cf.sym_combine(pm.clone().requires_grad_(), pm)
    with pytest.raises(ValueError, match="eps2"):
        cf.accel_sym(pm, G, eps2=0.0, b=128)


# ---------------------------------------------------------------- the steps
def jax_steps(cfg, pm, vel, n_real, k, dt=DT):
    n = pm.shape[0]
    step = jax.jit(jax_make_step_fn(cfg, n, n_real, platform="cpu"))
    s = JaxState(jnp.asarray(pm), jnp.asarray(vel), jnp.zeros((n, 4), jnp.float32), jnp.asarray(0, jnp.int32))
    for _ in range(k):
        s = step(s, jnp.float32(dt), jnp.float32(G))
    return [np.asarray(x) for x in (s.pos_mass, s.vel, s.accel)]


def torch_steps(cfg, pm, vel, n_real, k, dt=DT):
    n = pm.shape[0]
    step = make_step_fn(cfg, n, n_real, "cpu")
    s = SimState(torch.from_numpy(pm.copy()), torch.from_numpy(vel.copy()), torch.zeros((n, 4)), 0)
    for _ in range(k):
        s = step(s, dt, G)
    return [x.numpy() for x in (s.pos_mass, s.vel, s.accel)]


def assert_states_close(got, want, accel_rel):
    """p within 1e-6; v within 1e-6 of max(1, its scale) (the plummer
    velocities reach ~7, where an f32 ulp is 4.8e-7); accel max-abs/scale."""
    (p, v, a), (p0, v0, a0) = got, want
    np.testing.assert_allclose(p, p0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v0, rtol=0, atol=1e-6 * max(1.0, np.abs(v0).max()))
    assert rel(a, a0) < accel_rel


@pytest.mark.parametrize(
    "kw,n,n_real",
    [
        ({"integrator": "yoshida4", "block_target": 64}, 256, 256),  # tests/test_step.py:64-80
        ({"integrator": "yoshida4", "block_target": 128}, 384, 300),
        ({"integrator": "euler", "block_target": 128}, 256, 250),
        ({"fuse_epilogue": False, "block_target": 128}, 384, 384),
        ({"block_target": 256}, 256, 240),  # one tile: nt = 1
    ],
)
def test_unfused_sym_step_matches_jax(rng, kw, n, n_real):
    """Three steps of the port's unfused sym step against the JAX package's
    ``make_step_fn`` (backend "pallas", interpret mode) on the same route:
    ``make_sym_accel_fn`` + the integrator.  Padded rows stay frozen."""
    pm, vel = state(rng, n, n_real)
    got = torch_steps(SimConfig(force_mode="sym", **kw), pm, vel, n_real, 3)
    want = jax_steps(JaxConfig(backend="pallas", force_mode="sym", **kw), pm, vel, n_real, 3)
    assert_states_close(got, want, 2e-5)
    if n_real < n:
        np.testing.assert_array_equal(got[0][n_real:], pm[n_real:])
        assert not got[2][n_real:].any()


@pytest.mark.parametrize("n,b,n_real", [(256, 128, 256), (384, 128, 384), (512, 128, 500), (256, 128, 200)])
def test_fused_sym_step_matches_unfused(rng, n, b, n_real):
    """The port's fused sym step against its unfused one
    (``fuse_epilogue=False``), as ``tests/test_sym.py:418-461``."""
    pm, vel = state(rng, n, n_real)
    fused = torch_steps(SimConfig(force_mode="sym", block_target=b), pm, vel, n_real, 1)
    unfused = torch_steps(SimConfig(force_mode="sym", block_target=b, fuse_epilogue=False), pm, vel, n_real, 1)
    assert_states_close(fused, unfused, 5e-5)


def _sym_step_grads(cfg, pm, vel, n_real, steps=2):
    """``tests/test_sym.py:490-527``'s loss: gradients by pos_mass, vel, dt
    and G of ``sum |x|^2 + sum |v|^2`` after ``steps`` steps."""
    n = pm.shape[0]
    step = make_step_fn(cfg, n, n_real, "cpu")
    args = [torch.from_numpy(pm.copy()).requires_grad_(), torch.from_numpy(vel.copy()).requires_grad_(),
            torch.tensor(DT, requires_grad=True), torch.tensor(G, requires_grad=True)]
    s = SimState(args[0], args[1], torch.zeros((n, 4)), 0)
    for _ in range(steps):
        s = step(s, args[2], args[3])
    loss = torch.sum(s.pos_mass[:, :3] ** 2) + torch.sum(s.vel[:, :3] ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, args)]


def test_fused_sym_grad_matches_unfused(rng):
    n, n_real = 256, 250
    pm, vel = state(rng, n, n_real)
    gf = _sym_step_grads(SimConfig(force_mode="sym", block_target=128), pm, vel, n_real)
    gu = _sym_step_grads(SimConfig(force_mode="sym", block_target=128, fuse_epilogue=False), pm, vel, n_real)
    for got, want in zip(gf, gu):
        assert np.abs(got - want).max() / (np.abs(want).max() + 1e-30) < 1e-5


@pytest.mark.parametrize("integrator,n_real", [("yoshida4", 256), ("yoshida4", 250), ("euler", 256)])
def test_sym_rollout_grad_matches_jax_grad(rng, integrator, n_real):
    """The same loss through two steps of the unfused sym route against
    ``jax.grad`` through the JAX package's step (interpret mode)."""
    n = 256
    pm, vel = state(rng, n, n_real)
    got = _sym_step_grads(SimConfig(force_mode="sym", integrator=integrator, block_target=128), pm, vel, n_real)
    step = jax_make_step_fn(JaxConfig(backend="pallas", force_mode="sym", integrator=integrator, block_target=128),
                            n, n_real, platform="cpu")

    def loss(pos_mass, vel_, dt, G_):
        s = JaxState(pos_mass, vel_, jnp.zeros((n, 4), jnp.float32), jnp.int32(0))
        for _ in range(2):
            s = step(s, dt, G_)
        return jnp.sum(s.pos_mass[:, :3] ** 2) + jnp.sum(s.vel[:, :3] ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(jnp.asarray(pm), jnp.asarray(vel), jnp.float32(DT),
                                                         jnp.float32(G))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        assert np.abs(g - w).max() / (np.abs(w).max() + 1e-30) < 1e-5


# ------------------------------------------------------- engine and the CLI
@pytest.mark.parametrize(
    "kw", [{"integrator": "yoshida4"}, {"integrator": "euler"}, {"fuse_integrate": True}]
)
def test_sym_simulation_matches_jax(kw):
    """``Simulation`` (padded to the GPU tile: 768 rows, 3 tiles) against
    the JAX package's (backend "pallas", interpret mode: 2,048 rows, 8
    tiles), three steps of plummer n = 600.  With ``fuse_integrate`` both
    take the fused sym step, as JAX's dispatch reads the sym branches
    first."""
    cfg = {"force_mode": "sym", "block_target": 256, **kw}
    ts = Simulation.from_preset("plummer", SimConfig(**cfg), n=600, device="cpu")
    js = JaxSimulation.from_preset("plummer", JaxConfig(backend="pallas", **cfg), n=600, platform="cpu")
    ts.run(3, chunk=3)
    js.run(3, chunk=3)
    assert ts.n_pad == 768 and ts.step_count == js.step_count == 3
    assert_states_close(ts.arrays(), js.arrays(), 5e-5)
    evals = 3 if kw.get("integrator") == "yoshida4" else 1
    assert ts.pair_interactions_per_step == js.pair_interactions_per_step == evals * (600 * 600 - 600)


def test_cli_run_sym_yoshida4(capsys, tmp_path):
    reset_launch_counts()
    assert cli.main(["run", "--device", "cpu", "--preset", "uniform-sphere", "--n", "300", "--steps", "4",
                     "--log-every", "2", "--diagnostics", "--force-mode", "sym", "--integrator", "yoshida4",
                     "--outdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert sum(line.startswith("step=") for line in out.splitlines()) == 2 and "E=" in out
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
