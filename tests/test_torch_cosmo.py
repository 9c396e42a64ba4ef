"""The cosmological workflow of the port against the JAX package on the
CPU: the Zel'dovich box and the ``cosmo`` preset bit for bit
(``models/cosmo.py``), ``lcdm_growth`` and ``eh98_transfer`` to 1e-12, the
comoving background of ``ops/expansion.py`` (its float32 kick and drift
factors to 4e-7 of JAX's, and to f64 quadrature at tests/test_expansion.py's
bounds: 2e-6 EdS, 3e-6 ΛCDM), 5 comoving steps (EdS and ΛCDM, PM and P3M,
padded rows) at rtol 1e-4, atol 1e-5 of the max, the engine's scale factor,
its ``a=`` log field and metrics key, the validation's ``ValueError``s, the
live dt/G guard, the refused gradient by dt or G, and ``cli run --preset
cosmo --cosmology ... --analyze-every``.

Inputs: Zel'dovich boxes of 8³-10³ bodies from numpy seeds, box 10, grid 16
(tests/test_expansion.py's scale)."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.expansion as jexp  # noqa: E402
from nbody3d_tpu import cli as jax_cli  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.models import cosmo as jcosmo  # noqa: E402
from nbody3d_tpu.models.registry import make_preset as jax_make_preset  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import init_state as jax_init_state  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli  # noqa: E402
from nbody3d_tpu_torch.models import cosmo  # noqa: E402
from nbody3d_tpu_torch.models.registry import make_preset  # noqa: E402
from nbody3d_tpu_torch.ops import expansion  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

L = 10.0
G_N = 1e-4
MASS = 30.0


def _cfg(**kw) -> dict:
    base = dict(method="pm", boundary="periodic", box_size=L, pm_grid=16, p3m_nbr_k=4, G=G_N, cosmology="eds")
    base.update(kw)
    return base


def _t_i(n: int) -> float:
    return 2.0 / (3.0 * np.sqrt(8 * np.pi / 3 * G_N * MASS * n / L**3))


# ------------------------------------------------------------ models/cosmo.py


@pytest.mark.parametrize(
    "spectrum,velocity",
    [("power-law", "growing"), ("power-law", "eds"), ("power-law", "lcdm"), ("power-law", "cold"),
     ("eh98", "eds"), ("eh98", "lcdm")],
)
def test_zeldovich_box_bit_equal(spectrum, velocity):
    kw = dict(amp=0.02, index=-1.5, spectrum=spectrum, velocity=velocity, G=G_N, omega_lambda=0.6, box_mpc=250.0)
    got = cosmo.zeldovich_box(8, L, rng=np.random.default_rng(21), **kw)
    want = jcosmo.zeldovich_box(8, L, rng=np.random.default_rng(21), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [{"n": 1000}, {"n": 5000, "box_size": 4.0, "velocity": "eds"},
                                {"n": 512, "spectrum": "eh98", "box_mpc": 200.0, "velocity": "lcdm"}])
def test_cosmo_preset_bit_equal(kw):
    """The registry's ``cosmo`` (``n`` rounded to a cube, the seeded
    generator) against the JAX preset."""
    got = make_preset("cosmo", seed=3, G=G_N, **kw)
    want = jax_make_preset("cosmo", seed=3, G=G_N, **kw)
    assert got[0].shape[0] == round(kw["n"] ** (1 / 3)) ** 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_lcdm_growth_and_eh98_transfer_match():
    for a, ol in ((1.0, 0.7), (2.25, 0.7), (0.5, 0.3), (1.7, 1e-6)):
        np.testing.assert_allclose(cosmo.lcdm_growth(a, ol), jcosmo.lcdm_growth(a, ol), rtol=1e-12)
    k = np.logspace(-4, 2, 64)
    for kw in ({}, {"omega_m": 0.25, "omega_b": 0.12, "h": 0.7}):
        np.testing.assert_allclose(cosmo.eh98_transfer(k, **kw), jcosmo.eh98_transfer(k, **kw), rtol=1e-12)
    with pytest.raises(ValueError, match="omega_lambda"):
        cosmo.lcdm_growth(1.0, 1.0)


# ------------------------------------------------------- ops/expansion.py


def _f(x) -> float:
    return float(np.asarray(x))


@pytest.mark.parametrize("t1,t2", [(2.0, 2.05), (2.0, 8.0), (5.0, 5.0005), (2.0779, 2.1)])
def test_eds_factors_match_jax_and_quadrature(t1, t2):
    """tests/test_expansion.py::test_factors_match_quadrature on the port:
    the float32 factors within 4e-7 of JAX's and 2e-6 of f64 quadrature."""
    t_i = 2.0779
    t = np.linspace(t1, t2, 200_001)
    a = (t / t_i) ** (2.0 / 3.0)
    refs = (np.trapezoid(1.0 / a, t), np.trapezoid(1.0 / a**2, t))
    args = (np.float32(t1), np.float32(t2 - t1), np.float32(t_i))
    for fn, jfn, ref in ((expansion.kick_factor, jexp.kick_factor, refs[0]),
                         (expansion.drift_factor, jexp.drift_factor, refs[1])):
        got, want = _f(fn(*args)), _f(jfn(*args))
        assert abs(got - want) <= 4e-7 * abs(want), (got, want)
        assert abs(got - ref) <= 2e-6 * abs(ref) + 1e-12, (got, ref)
    assert abs(_f(expansion.eds_scale_factor(torch.tensor(np.float32(t2)), torch.tensor(args[2])))
               - _f(jexp.eds_scale_factor(jnp.float32(t2), jnp.float32(t_i)))) <= 4e-7


@pytest.mark.parametrize("ol", [0.3, 0.7])
@pytest.mark.parametrize("t1_fac,t2_fac", [(1.0, 1.02), (1.0, 3.0), (2.5, 2.5002)])
def test_lcdm_factors_match_jax_and_quadrature(ol, t1_fac, t2_fac):
    """tests/test_expansion.py::test_lcdm_factors_match_quadrature on the
    port's ``make_background``: ``t_i`` and the GL8 factors within 4e-7 of
    JAX's float32 values (XLA's float32 sinh is itself ~5e-7 off f64, the
    port's ~1e-7), and 2e-6 / 3e-6 of f64; ``lcdm_scale_factor`` within
    1e-6 of JAX's and 2e-6 of f64."""
    G, rho = 1e-4, 100.0
    om = 1.0 - ol
    h_i = np.sqrt(8 * np.pi / 3 * G * rho / om)
    s = 1.5 * np.sqrt(ol) * h_i
    t_i = np.arcsinh(np.sqrt(ol / om)) / s
    t1, t2 = t1_fac * t_i, t2_fac * t_i
    t = np.linspace(t1, max(t2, t1 * (1 + 1e-9)), 400_001)
    a = (om / ol) ** (1 / 3) * np.sinh(s * t) ** (2.0 / 3.0)
    refs = (np.trapezoid(1.0 / a, t), np.trapezoid(1.0 / a**2, t))

    cfg = _cfg(cosmology="lcdm", omega_lambda=ol)
    bg_init, kick_fn, drift_fn = expansion.make_background(SimConfig(**cfg))
    jbg_init, jkick_fn, jdrift_fn = jexp.make_background(JaxConfig(**cfg))
    bg, jbg = bg_init(np.float32(G), np.float32(rho)), jbg_init(np.float32(G), np.float32(rho))
    assert abs(_f(bg["t_i"]) - _f(jbg["t_i"])) <= 4e-7 * _f(jbg["t_i"])
    assert abs(_f(bg["t_i"]) - t_i) <= 2e-6 * t_i
    a = _f(expansion.lcdm_scale_factor(np.float32(t2), np.float32(t_i), ol))
    assert abs(a - _f(jexp.lcdm_scale_factor(jnp.float32(t2), jnp.float32(t_i), ol))) <= 1e-6 * a
    assert abs(a - (om / ol) ** (1 / 3) * np.sinh(s * t2) ** (2.0 / 3.0)) <= 2e-6 * a
    args = (np.float32(t1), np.float32(t2 - t1))
    for fn, jfn, ref in ((kick_fn, jkick_fn, refs[0]), (drift_fn, jdrift_fn, refs[1])):
        got, want = _f(fn(bg, *args)), _f(jfn(jbg, *args))
        assert abs(got - want) <= 4e-7 * abs(want), (got, want)
        assert abs(got - ref) <= 3e-6 * abs(ref) + 1e-10, (got, ref)


@pytest.mark.parametrize("cosmology", ["eds", "lcdm"])
def test_step_factors_match_jax(cosmology):
    """The step's kick and drift (the two windows in one length-2 pass, the
    GL8 nodes as one (2, 8) array) against JAX's ``comoving_update`` on a
    unit force: at step 0 (the opening half-kick) and at step 37, within
    4e-7 of JAX's float32 factors."""
    cfg = _cfg(cosmology=cosmology, omega_lambda=0.7)
    rho, dt, G = 15.36, 0.0731, np.float32(G_N)
    one = np.ones((1, 4), np.float32)
    zero = np.zeros((1, 4), np.float32)
    for step in (0, 37):
        p, w, _ = expansion.comoving_update(SimConfig(**cfg), torch.from_numpy(one), torch.from_numpy(zero),
                                            torch.from_numpy(zero), step, dt, G, torch.tensor(np.float32(rho)), None)
        jp, jw, _ = jexp.comoving_update(JaxConfig(**cfg), jnp.asarray(one), jnp.asarray(zero), jnp.asarray(zero),
                                         jnp.int32(step), dt, G, jnp.float32(rho), None)
        kick, drift = float(w[0, 0]), float(p[0, 0]) / float(w[0, 0])
        jkick, jdrift = float(jw[0, 0]), float(jp[0, 0]) / float(jw[0, 0])
        assert abs(kick - jkick) <= 4e-7 * jkick and abs(drift - jdrift) <= 4e-7 * jdrift, (kick, jkick, drift, jdrift)


def _box(n_per_dim: int, velocity: str, n_real: int, n_pad: int, seed: int = 11):
    pm_np, vel_np, _ = cosmo.zeldovich_box(n_per_dim, L, amp=0.02, velocity=velocity, G=G_N, omega_lambda=0.7,
                                           rng=np.random.default_rng(seed))
    pad = ((0, n_pad - n_real), (0, 0))
    return np.pad(pm_np[:n_real], pad), np.pad(vel_np[:n_real], pad)


@pytest.mark.parametrize("cosmology", ["eds", "lcdm"])
@pytest.mark.parametrize("method", ["pm", "p3m"])
def test_comoving_steps_match_jax(cosmology, method):
    """``make_step_fn`` (the kernel route: on the CPU the twins) against the
    JAX comoving step (``backend="jnp"``): 5 steps of a Zel'dovich box of
    500 bodies in 512 rows from a = 1 over ~0.2 of t_i, positions, momenta
    and the stored force at rtol 1e-4, atol 1e-5 of the max."""
    pm_np, vel_np = _box(8, cosmology, 500, 512)
    cfg = _cfg(method=method, cosmology=cosmology, omega_lambda=0.7)
    step = make_step_fn(SimConfig(**cfg), 512, 500, "cpu")
    jstep = jax_make_step_fn(JaxConfig(backend="jnp", **cfg), 512, 500)
    s = SimState(torch.from_numpy(pm_np), torch.from_numpy(vel_np), torch.zeros((512, 4)), 0)
    js = jax_init_state(pm_np, vel_np, n_pad=512)
    dt = 0.04 * _t_i(500)
    for _ in range(5):
        s = step(s, dt, G_N)
        js = jstep(js, dt, G_N)
    assert s.step == 5
    moved = np.abs(s.pos_mass.numpy()[:500, :3] - pm_np[:500, :3]).max()
    assert moved > 1e-3, moved
    for got, want in ((s.pos_mass, js.pos_mass), (s.vel, js.vel), (s.accel, js.accel)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(s.pos_mass.numpy()[500:], pm_np[500:])
    assert not s.accel[500:].any()


def test_zero_amplitude_lattice_static():
    """tests/test_expansion.py::test_zero_amplitude_lattice_static: a cold
    lattice feels no force and never moves."""
    pm0, vel0, _ = cosmo.zeldovich_box(8, L, amp=0.0, velocity="eds", rng=np.random.default_rng(2))
    sim = Simulation(SimConfig(**_cfg()), pm0, vel0, device="cpu")
    sim.run(10, chunk=5)
    pos, vel, _ = sim.arrays()
    np.testing.assert_allclose(pos[:, :3], pm0[:, :3], atol=1e-5)
    np.testing.assert_allclose(vel, 0.0, atol=1e-6)


@pytest.mark.parametrize("cosmology", ["eds", "lcdm"])
def test_scale_factor_log_and_metrics_match_jax(cosmology, tmp_path):
    """``Simulation.scale_factor`` (1 at step 0), the ``a=`` log field and
    the metrics' ``a`` after 5 steps equal the JAX engine's; static space
    has none."""
    pm0, vel0, _ = cosmo.zeldovich_box(8, L, amp=0.01, velocity=cosmology, omega_lambda=0.7,
                                       rng=np.random.default_rng(5))
    cfg = _cfg(cosmology=cosmology, omega_lambda=0.7, dt=0.1 * _t_i(512))
    sim = Simulation(SimConfig(**cfg), pm0, vel0, device="cpu")
    jsim = JaxSimulation(JaxConfig(backend="jnp", **cfg), pm0, vel0)
    assert sim.scale_factor == jsim.scale_factor and abs(sim.scale_factor - 1.0) < 1e-12
    sim.metrics_path, jsim.metrics_path = str(tmp_path / "m.jsonl"), str(tmp_path / "jm.jsonl")
    sim.run(5, chunk=5)
    jsim.run(5, chunk=5)
    assert sim.scale_factor == jsim.scale_factor > 1.0
    field = [f for f in next(iter(jsim.log_lines())).split() if f.startswith("a=")]
    assert len(field) == 1 and field[0] in next(iter(sim.log_lines())).split()
    rec, jrec = (json.loads(open(p).read().splitlines()[-1]) for p in (sim.metrics_path, jsim.metrics_path))
    assert rec["a"] == jrec["a"]
    static = Simulation(SimConfig(**_cfg(cosmology="none")), pm0, vel0, device="cpu")
    assert static.scale_factor is None and " a=" not in next(iter(static.log_lines()))


@pytest.mark.parametrize(
    "kw",
    [dict(boundary="isolated", box_size=0.0, method="direct"), dict(method="direct"), dict(integrator="yoshida4"),
     dict(integrator="euler"), dict(boundary="isolated", method="pm"), dict(cosmology="wcdm"),
     dict(cosmology="lcdm", omega_lambda=1.5), dict(cosmology="lcdm", omega_lambda=0.0)],
)
def test_validation_raises_jax_errors(kw):
    """Each configuration the JAX package refuses raises the same
    ``ValueError`` with the same message when the port builds its step."""
    pm0, vel0, _ = cosmo.zeldovich_box(8, L, amp=0.01, velocity="eds", rng=np.random.default_rng(3))
    cfg = _cfg(**kw)
    with pytest.raises(ValueError) as want:
        JaxSimulation(JaxConfig(backend="jnp", **cfg), pm0, vel0)
    with pytest.raises(ValueError) as got:
        Simulation(SimConfig(**cfg), pm0, vel0, device="cpu")
    assert str(got.value) == str(want.value)


def test_live_dt_and_G_guard_matches_jax():
    """The dt/G setters on a comoving run: free before the first step,
    refused after it (ValueError, JAX's message), pause and unpause allowed,
    ``_set_runtime`` past the guard; a static run takes any change."""
    pm0, vel0, _ = cosmo.zeldovich_box(8, L, amp=0.01, velocity="eds", rng=np.random.default_rng(4))
    cfg = _cfg(dt=0.05 * _t_i(512))
    sims = (Simulation(SimConfig(**cfg), pm0, vel0, device="cpu"), JaxSimulation(JaxConfig(backend="jnp", **cfg),
                                                                                pm0, vel0))
    msgs = []
    for sim in sims:
        sim.dt = 0.04 * _t_i(512)
        sim.G = 2e-4
        sim.G = 1e-4
        sim.run(1)
        sim.dt = sim.dt  # no change
        with pytest.raises(ValueError, match="mid-run") as e:
            sim.dt = 0.5 * sim.dt
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="mid-run") as e:
            sim.G = 3e-4
        msgs.append(str(e.value))
        sim.toggle_pause()
        assert sim.paused and sim.dt == 0.0
        sim.toggle_pause()
        assert sim.dt == np.float64(0.04 * _t_i(512))
        sim._set_runtime(dt=1.0, G=5e-4)
        assert (sim.dt, sim.G) == (1.0, 5e-4)
    assert msgs[:2] == msgs[2:]
    static = Simulation(SimConfig(**_cfg(cosmology="none")), pm0, vel0, device="cpu")
    static.run(1)
    static.dt, static.G = 1e-3, 2e-4
    assert (static.dt, static.G) == (1e-3, 2e-4)


def test_gradient_by_dt_or_G_raises_and_by_state_flows():
    """dt and G enter the comoving step as host floats: asking for their
    gradient raises; a gradient by the initial momenta flows."""
    pm_np, vel_np = _box(8, "eds", 512, 512)
    step = make_step_fn(SimConfig(**_cfg()), 512, 512, "cpu")
    dt = 0.05 * _t_i(512)
    for bad in ((torch.tensor(dt, requires_grad=True), G_N), (dt, torch.tensor(G_N, requires_grad=True))):
        s = SimState(torch.from_numpy(pm_np), torch.from_numpy(vel_np), torch.zeros((512, 4)), 0)
        with pytest.raises(RuntimeError, match="no gradient by them"):
            step(s, *bad)
    v0 = torch.from_numpy(vel_np).requires_grad_()
    s = SimState(torch.from_numpy(pm_np), v0, torch.zeros((512, 4)), 0)
    for _ in range(2):
        s = step(s, dt, G_N)
    (g,) = torch.autograd.grad((s.pos_mass[:, :3] ** 2).sum(), v0)
    assert torch.isfinite(g).all() and g[:, :3].abs().max() > 0


# ---------------------------------------------------------------- the CLI


def test_cli_run_cosmo_analyze_every_matches_jax(tmp_path, capsys):
    """``run --preset cosmo --cosmology eds --boundary periodic --method
    p3m --analyze-every 2`` on both CLIs: the same analysis.jsonl records
    (keys, steps and values at rtol 1e-4) and final states (rtol 1e-4,
    atol 1e-5 of the max); nothing launches on the CPU.  Then ``analyze
    --fof --power-spectrum 64 --json`` of the port's checkpoint on both:
    the same keys and catalog, the mode counts equal, P at rtol 1e-4 and
    3e-5 of its largest bin."""
    args = ["run", "--preset", "cosmo", "--n", "512", "--cosmology", "eds", "--boundary", "periodic",
            "--box-size", "10", "--method", "p3m", "--pm-grid", "16", "--p3m-nbr-k", "4", "--steps", "4",
            "--log-every", "2", "--analyze-every", "2", "--dt", str(0.05 * _t_i(512))]
    reset_launch_counts()
    assert cli.main(args + ["--device", "cpu", "--outdir", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    assert jax_cli.main(args + ["--backend", "jnp", "--outdir", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out
    assert all(c == 0 for c in launch_counts().values())
    assert "a=" in out and "r50=" in out and "r50=" in jout
    recs, jrecs = ([json.loads(line) for line in (tmp_path / d / "analysis.jsonl").read_text().splitlines()]
                   for d in ("t", "j"))
    assert [r["step"] for r in recs] == [r["step"] for r in jrecs] == [2, 4]
    for r, jr in zip(recs, jrecs):
        assert r.keys() == jr.keys() and "potential" not in r
        assert r["n_massive"] == jr["n_massive"] == 512
        for key in ("total_mass", "kinetic", "kinetic_com"):
            assert r[key] == pytest.approx(jr[key], rel=1e-4)
        for key in ("com", "lagrangian_radii"):
            np.testing.assert_allclose(list(np.ravel(list(r[key].values()) if isinstance(r[key], dict)
                                                     else r[key])),
                                       list(np.ravel(list(jr[key].values()) if isinstance(jr[key], dict)
                                                     else jr[key])), rtol=1e-4)
    with np.load(tmp_path / "t" / "final.npz") as t, np.load(tmp_path / "j" / "final.npz") as j:
        for name in ("pos_mass", "vel"):
            np.testing.assert_allclose(t[name], j[name], rtol=1e-4, atol=1e-5 * np.abs(j[name]).max())
    sim = Simulation.load(str(tmp_path / "t" / "final.npz"), device="cpu")
    assert sim.config.cosmology == "eds" and sim.step_count == 4 and sim.scale_factor > 1.0
    # analyze of the port's checkpoint through both CLIs: P(k) on the torus,
    # the periodic FoF.
    args = ["analyze", str(tmp_path / "t" / "final.npz"), "--fof", "--fof-min-size", "2", "--power-spectrum",
            "64", "--json", "--bins", "8"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(args + ["--backend", "jnp"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["fof"] == want["fof"]
    ps, jps = got["power_spectrum"], want["power_spectrum"]
    assert ps["n_modes"] == jps["n_modes"] and len(ps["P"]) == 32
    # A 512-body lattice on 64³ cells: P spans 1e7 between its harmonics and
    # the rest, and float32 FFTs (pocketfft, XLA's) differ by ~1e-5 of the
    # largest bin there.
    np.testing.assert_allclose(ps["P"], jps["P"], rtol=1e-4, atol=3e-5 * max(jps["P"]))
    np.testing.assert_allclose(ps["k"] + [ps["shot_noise"]], jps["k"] + [jps["shot_noise"]], rtol=1e-6)


def test_cli_omega_lambda_needs_lcdm(tmp_path):
    with pytest.raises(SystemExit, match="only applies to --cosmology lcdm"):
        cli.main(["run", "--preset", "cosmo", "--n", "512", "--omega-lambda", "0.6", "--device", "cpu",
                  "--outdir", str(tmp_path)])
