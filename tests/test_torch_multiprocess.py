"""Multi-rank plumbing of the port: the spawn helper (results, a rank
that raises, a rank that hangs), the mesh constructors, the engine on a
mesh (Morton re-sorts, diagnostics, checkpoints, the refused frame),
``cli run --devices 4 --device cpu`` against the JAX package's
``cli run --devices 4``, and the refusals of what is not ported."""

import json
import time

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu import cli as jax_cli  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu_torch import cli  # noqa: E402
from nbody3d_tpu_torch.config import SimConfig  # noqa: E402
from nbody3d_tpu_torch.engine import Simulation  # noqa: E402
from nbody3d_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from nbody3d_tpu_torch.parallel import rank_checks  # noqa: E402
from nbody3d_tpu_torch.parallel.launch import spawn  # noqa: E402
from nbody3d_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from nbody3d_tpu_torch.parallel.sharded import make_sharded_step  # noqa: E402

ENGINE = dict(preset="plummer", n=600, steps=4, chunk=2)


@pytest.fixture(scope="module")
def d4(tmp_path_factory):
    """One group of 4 gloo ranks: the mesh views (1-D, the default grid),
    the constructors' errors, and two engine runs (the plain route with
    Morton re-sorts; ringsym on the kernel route)."""
    tmp = tmp_path_factory.mktemp("ranks")
    cases = [
        dict(kind="mesh", mesh="x"),
        dict(kind="mesh", mesh=(None, None)),
        dict(kind="mesh_errors"),
        dict(kind="engine", config=dict(backend="jnp", strategy="ring", morton_every=2), path=str(tmp / "a"),
             **ENGINE),
        dict(kind="engine", config=dict(force_mode="sym", strategy="ring", morton_every=2, block_target=64),
             path=str(tmp / "b"), **ENGINE),
        dict(kind="order", config=dict(backend="jnp", strategy="ring"), n=256, seed=0),
        dict(kind="order", config=dict(strategy="ring"), n=256, seed=0),
    ]
    return spawn(rank_checks.run_cases, 4, cases, device="cpu", timeout=240)


# ------------------------------------------------------ the spawn helper
def test_spawn_returns_each_ranks_result():
    out = spawn(rank_checks.env_of, 3, device="cpu", timeout=120, threads=1)
    assert [r["rank"] for r in out] == [0, 1, 2]
    assert all(r["world"] == 3 and r["backend"] == "gloo" and r["threads"] == 1 for r in out)
    assert not any(r["jax"] for r in out)
    assert len({r["pid"] for r in out}) == 3


def test_a_rank_that_raises_fails_the_run_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn(rank_checks.raise_on, 3, 1, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 60


def test_a_rank_that_hangs_fails_at_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[.*1.*\] still running"):
        spawn(rank_checks.hang_on, 2, 1, device="cpu", timeout=8)
    assert time.monotonic() - t0 < 40


def test_spawn_needs_a_device():
    """No default device: a caller that names none gets no ranks at all,
    never quiet CPU ones."""
    with pytest.raises(TypeError, match="device"):
        spawn(rank_checks.env_of, 2, timeout=30)


def test_spawn_refuses_more_ranks_than_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards: NCCL can take two ranks")
    with pytest.raises(RuntimeError, match="cards"):
        spawn(rank_checks.env_of, 2, device="cuda")


# --------------------------------------------------------------- the mesh
def test_mesh_needs_a_process_group():
    for make in (mesh_mod.default_mesh, mesh_mod.grid_mesh):
        with pytest.raises(RuntimeError, match="process group"):
            make()
    info = mesh_mod.mesh_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert set(info) == {"platform", "n_devices", "device_kind", "process_index", "process_count"}


def test_mesh_views_on_each_rank(d4):
    """1-D: the world along "x".  The default grid of 4 ranks is 2 x 2,
    rank-major; along "col" the ranks of one row, along "row" one
    column, each in group order."""
    for rank, out in enumerate(d4):
        flat, grid = out[0], out[1]
        assert flat["shape"] == (4,) and flat["coords"] == (rank,) and flat["along"] == {"x": [0, 1, 2, 3]}
        r, c = divmod(rank, 2)
        assert grid["shape"] == (2, 2) and grid["axes"] == ("row", "col") and grid["coords"] == (r, c)
        assert grid["along"] == {"col": [2 * r, 2 * r + 1], "row": [c, 2 + c]}
        assert grid["info"]["process_index"] == rank and grid["info"]["n_devices"] == 4


def test_mesh_constructors_refuse_what_does_not_fit(d4):
    errors = d4[0][2]
    assert "requested 5 devices" in errors[0]
    assert "rows=5 does not divide 4" in errors[1]
    assert "mesh 2x4 != 4 devices" in errors[2]


def test_ring_posts_the_next_transfer_before_each_hops_force(d4):
    """The counterpart of ``tests/test_ring_overlap.py``: on each of the D
    = 4 hops but the last, the transfer of hop k+1's shard is posted before
    hop k's force is called; the last hop posts none."""
    want = ["send", "force"] * 3 + ["force"]
    assert d4[0][5] == want  # the plain route
    assert d4[0][6] == want  # the kernel route (force_exact's twin)


# ------------------------------------------------------------- the engine
def test_engine_on_a_mesh_matches_jax(d4):
    """``Simulation(mesh=...)`` on the plain route, Morton re-sorts every 2
    steps, against the JAX package's engine with the same re-sorts.  That
    engine cannot re-sort on a mesh (its ``morton_reorder`` gathers a
    sharded array and raises ``ShardingTypeError`` under this jax), so it
    runs on one device; its padding is the mesh's."""
    out = d4[0][3]
    js = JaxSimulation.from_preset("plummer", JaxConfig(backend="jnp", morton_every=2), n=600, platform="cpu")
    js.run(4, chunk=2)
    assert out["step"] == 4 and out["n_pad"] == 608 and out["shard"] == 152
    (tp, tv, ta), (jp, jv, ja) = out["arrays"], js.arrays()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    assert np.abs(tv - jv).max() <= 1e-5 * np.abs(jv).max()
    assert np.abs(ta - ja).max() <= 1e-4 * np.abs(ja).max()
    dj = js.diagnostics()
    np.testing.assert_allclose(out["diag"][2], float(dj.total_energy), rtol=1e-5)
    np.testing.assert_allclose(out["diag"][1], float(dj.potential), rtol=1e-5)


@pytest.mark.parametrize("which", [3, 4])
def test_engine_checkpoints_round_trip_and_refuse_to_render(d4, which):
    """Saved by rank 0 from the gathered state, loaded on every rank and
    sharded again: bit for bit (npz, and the JSON's float32 reprs); a frame
    of a sharded state names ROADMAP item 11c."""
    out = d4[0][which]
    for suffix in (".npz", ".json"):
        for a, b in zip(out["arrays"], out["loaded" + suffix]):
            np.testing.assert_array_equal(a, b)
    assert "11c" in out["render_error"]


def test_engine_ringsym_on_kernel_route_matches_one_device(d4):
    """ringsym on the kernel route (the sym chain's and ``pair_sym``'s
    twins) with Morton re-sorts against the port's own single-device sym
    step and the JAX package's plain engine."""
    out = d4[0][4]
    one = Simulation.from_preset("plummer", SimConfig(force_mode="sym", morton_every=2, block_target=64), n=600,
                                 device="cpu")
    one.run(4, chunk=2)
    js = JaxSimulation.from_preset("plummer", JaxConfig(backend="jnp", morton_every=2), n=600, platform="cpu")
    js.run(4, chunk=2)
    assert out["n_pad"] == 1024 and out["shard"] == 256
    for want in (one.arrays(), js.arrays()):
        np.testing.assert_allclose(out["arrays"][0], want[0], rtol=1e-5, atol=1e-6)
        assert np.abs(out["arrays"][2] - want[2]).max() <= 1e-4 * np.abs(want[2]).max()


# ------------------------------------------------------------------ cli
def test_cli_run_devices_matches_jax_cli(tmp_path, capsys):
    """``run --devices 4 --device cpu`` (4 gloo ranks, rank 0 writes)
    against the JAX CLI's ``run --devices 4`` on its virtual mesh: the
    final checkpoint and a mid-run one, 4 steps with diagnostics (no
    Morton re-sort: the JAX engine cannot re-sort on a mesh, see
    :func:`test_engine_on_a_mesh_matches_jax`)."""
    flags = ["--preset", "uniform-sphere", "--n", "512", "--steps", "4", "--log-every", "2", "--diagnostics",
             "--checkpoint-every", "2", "--backend", "jnp", "--devices", "4", "--strategy", "ring"]
    assert cli.main(["run", *flags, "--device", "cpu", "--outdir", str(tmp_path / "t")]) == 0
    assert jax_cli.main(["run", *flags, "--outdir", str(tmp_path / "j")]) == 0
    for name in ("final.npz", "ckpt_00000002.npz"):
        t, j = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert int(t["step"]) == int(j["step"])
        np.testing.assert_allclose(t["pos_mass"], j["pos_mass"], rtol=1e-5, atol=1e-6)
        assert np.abs(t["vel"] - j["vel"]).max() <= 1e-5 * np.abs(j["vel"]).max()
        saved = json.loads(bytes(t["config_json"]).decode())
        assert saved["strategy"] == "ring" and saved["backend"] == "jnp"
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())


def test_cli_run_devices_p3m_matches_jax_cli(tmp_path):
    """``run --devices 4 --device cpu --method p3m`` (the splitter exchange,
    the halo ring) against the JAX CLI's ``run --devices 4 --method p3m``
    on its virtual mesh: the final checkpoint and a mid-run one, 4 steps
    with diagnostics (P3M's bounds: positions rtol 1e-5, velocities 1e-4 of
    the max)."""
    flags = ["--preset", "two-galaxy", "--n", "1000", "--steps", "4", "--log-every", "2", "--diagnostics",
             "--checkpoint-every", "2", "--backend", "jnp", "--devices", "4", "--method", "p3m", "--pm-grid", "32",
             "--p3m-nbr-k", "16"]
    assert cli.main(["run", *flags, "--device", "cpu", "--outdir", str(tmp_path / "t")]) == 0
    assert jax_cli.main(["run", *flags, "--outdir", str(tmp_path / "j")]) == 0
    for name in ("final.npz", "ckpt_00000002.npz"):
        t, j = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert int(t["step"]) == int(j["step"])
        np.testing.assert_allclose(t["pos_mass"], j["pos_mass"], rtol=1e-5, atol=1e-6)
        assert np.abs(t["vel"] - j["vel"]).max() <= 1e-4 * np.abs(j["vel"]).max()
        saved = json.loads(bytes(t["config_json"]).decode())
        assert saved["method"] == "p3m" and saved["pm_grid"] == 32
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())


def test_cli_info_reports_the_mesh(capsys):
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert {"platform", "n_devices", "device_kind", "process_index", "process_count", "torch"} <= set(info)
    assert set(info["sharded"]) == {"direct", "pm", "p3m"}


# ------------------------------------------------------------ refusals
def _fake_mesh(shape=(4,), axes=("x",)):
    """A mesh object for the checks made before any collective."""
    return Mesh(shape, axes, 0, torch.device("cpu"), {a: None for a in axes})


def test_ringsym_refuses_exact_mode_on_the_kernel_route():
    cfg = SimConfig(force_mode="exact", strategy="ringsym", block_target=32)
    with pytest.raises(ValueError, match="ringsym"):
        make_sharded_step(cfg, 1024, 1024, _fake_mesh())
    make_sharded_step(cfg.replace(backend="jnp"), 1024, 1024, _fake_mesh())  # the plain route takes it


@pytest.mark.parametrize("method", ["pm", "p3m"])
def test_mesh_methods_build_sharded_steps(method):
    """PM and P3M build their sharded steps (isolated, periodic,
    interlaced, comoving; on the 1-D mesh and the 2 x 2 grid, whatever the
    strategy) without a collective; a comoving run needs a mesh method and
    the periodic box, as in the JAX package."""
    box = dict(boundary="periodic", box_size=1.0)
    for cfg in (SimConfig(method=method), SimConfig(method=method, **box, mesh_interlace=True),
                SimConfig(method=method, **box, cosmology="eds"), SimConfig(method=method, strategy="ringsym")):
        assert callable(make_sharded_step(cfg, 1024, 1000, _fake_mesh()))
    for strategy in ("2d", "ring"):
        cfg = SimConfig(method=method, strategy=strategy, **box, cosmology="lcdm")
        assert callable(make_sharded_step(cfg, 1024, 1024, _fake_mesh((2, 2), ("row", "col"))))
    with pytest.raises(ValueError, match="mesh solver"):
        make_sharded_step(SimConfig(cosmology="eds", **box), 1024, 1024, _fake_mesh())
    with pytest.raises(ValueError, match="periodic"):
        make_sharded_step(SimConfig(method=method, cosmology="eds"), 1024, 1024, _fake_mesh())
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_step(SimConfig(method=method), 1000, 1000, _fake_mesh((3,)))


def test_strategies_check_the_mesh_shape():
    with pytest.raises(ValueError, match="2-axis"):
        make_sharded_step(SimConfig(strategy="2d"), 1024, 1024, _fake_mesh())
    with pytest.raises(ValueError, match="axis 'x'"):
        make_sharded_step(SimConfig(strategy="ring"), 1024, 1024, _fake_mesh((2, 2), ("row", "col")))
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_step(SimConfig(strategy="gather"), 1000, 1000, _fake_mesh((3,)))


def test_sharded_simulation_refuses_to_render():
    pm, v = rank_checks.random_bodies(0, 64)
    sim = Simulation(SimConfig(backend="jnp"), pm, v, mesh=_fake_mesh((1,)))
    assert sim.device == torch.device("cpu") and sim.n_pad == 64
    for render in (sim.render_frame, sim.render_frame_begin):
        with pytest.raises(NotImplementedError, match="11c"):
            render()
    with pytest.raises(TypeError, match="device"):
        Simulation(SimConfig(), pm, v)


@pytest.mark.parametrize("command", ["animate", "serve"])
@pytest.mark.parametrize("flag", [["--devices", "2"], ["--distributed"]])
def test_cli_rendering_commands_refuse_a_mesh(tmp_path, command, flag):
    """``animate`` and ``serve`` render, which a sharded state cannot yet:
    they refuse the mesh flags before any rank starts."""
    args = [str(tmp_path / "missing.npz")] if command == "animate" else []
    with pytest.raises(NotImplementedError, match="11c"):
        cli.main([command, *args, *flag, "--device", "cpu"])


def _distributed_run(flags, out):
    """Two processes as ``torchrun`` starts them (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT on localhost).  The port is a free one
    at the time it is picked; another process may take it before rank 0
    binds it, so a run that fails on an address in use is made again on
    a new port.  Returns the processes' (stdout, stderr) and exit codes."""
    import os
    import pathlib
    import shutil
    import socket
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    for _ in range(4):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "nbody3d_tpu_torch.cli", *flags, "--distributed", "--outdir",
                 str(out / f"r{rank}")], cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                p.kill()
        codes = [p.returncode for p in procs]
        if codes == [0, 0] or not any("address already in use" in e.lower() for _, e in outs):
            return outs, codes
        for rank in range(2):
            shutil.rmtree(out / f"r{rank}", ignore_errors=True)
    return outs, codes


def test_cli_distributed_joins_the_env_process_group(tmp_path):
    """``run --distributed`` on two gloo ranks (``--device cpu``): rank 0
    alone prints and writes, and the final state matches the JAX CLI's
    ``run`` on the same flags and the port's own one-device run."""
    flags = ["run", "--preset", "uniform-sphere", "--n", "256", "--steps", "2", "--log-every", "2",
             "--backend", "jnp"]
    outs, codes = _distributed_run([*flags, "--device", "cpu"], tmp_path)
    assert codes == [0, 0], [o[1][-2000:] for o in outs]
    assert "step=2" in outs[0][0] and outs[1][0] == ""
    assert (tmp_path / "r0" / "final.npz").exists() and not (tmp_path / "r1").exists()
    assert cli.main([*flags, "--device", "cpu", "--outdir", str(tmp_path / "one")]) == 0
    assert jax_cli.main([*flags, "--outdir", str(tmp_path / "j")]) == 0
    t, o, j = (np.load(tmp_path / d / "final.npz") for d in ("r0", "one", "j"))
    np.testing.assert_allclose(t["pos_mass"], o["pos_mass"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t["pos_mass"], j["pos_mass"], rtol=1e-5, atol=1e-6)
    assert np.abs(t["vel"] - j["vel"]).max() <= 1e-5 * np.abs(j["vel"]).max()
