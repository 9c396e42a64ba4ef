"""Multi-rank plumbing of the port: the spawn helper (results, a rank
that raises, a rank that hangs), the mesh constructors, the engine on a
mesh (Morton re-sorts, diagnostics, checkpoints, ``regenerate``, frames by
every resolve bit-equal to one device's), the served mesh (rank 0's
viewer and its followers), ``dryrun_multichip``, ``cli run --devices 4
--device cpu`` against the JAX package's ``cli run --devices 4``, ``serve``
and ``animate`` with the mesh flags, and the refusals."""

import json
import os
import select
import signal
import subprocess
import sys
import time
import urllib.request

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
        dict(kind="render", config=dict(backend="jnp", morton_every=2), preset="plummer", n=600, steps=4, chunk=2),
        dict(kind="render", config=dict(method="p3m", pm_grid=32, p3m_nbr_k=16), preset="two-galaxy", n=1000,
             steps=1, chunk=1),
        dict(kind="regenerate", preset="plummer", n=600),
    ]
    return spawn(rank_checks.run_cases, 4, cases, device="cpu", timeout=240)


def one_device_frame(arrays, resolve="auto"):
    """The one-device frame of the real rows ``arrays`` (pos_mass, vel,
    accel) at the rank cases' camera and size."""
    one = Simulation(SimConfig(backend="jnp"), *arrays, device="cpu")
    return one.render_frame(camera=rank_checks.frame_camera(), resolve=resolve, **rank_checks.FRAME)


# ------------------------------------------------------ the spawn helper
def test_spawn_returns_each_ranks_result():
    out = spawn(rank_checks.env_of, 3, device="cpu", timeout=120, threads=1)
    assert [r["rank"] for r in out] == [0, 1, 2]
    assert all(r["world"] == 3 and r["backend"] == "gloo" and r["threads"] == 1 for r in out)
    assert not any(r["jax"] for r in out)
    assert len({r["pid"] for r in out}) == 3


def test_no_rank_leaves_its_group_before_every_rank_is_done():
    """A rank that returns first waits for the others before it tears its
    side of the group down.  Without that wait a fast rank could exit while
    a slow one was still connecting in ``init_process_group``, and the slow
    one failed ("Gloo connectFullMesh failed ... Connection closed by
    peer"): rank 0 of ``spawn(env_of, 3)`` did so under a loaded host."""
    out = spawn(rank_checks.peers_running_after, 3, 3.0, device="cpu", timeout=120)
    assert out[0] == [True, True] and out[1:] == [None, None]


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
    sharded again: bit for bit (npz, and the JSON's float32 reprs); the
    loaded sharded state's frame (the sharded render) equals one device's
    frame of the same rows, bit for bit."""
    out = d4[0][which]
    for suffix in (".npz", ".json"):
        for a, b in zip(out["arrays"], out["loaded" + suffix]):
            np.testing.assert_array_equal(a, b)
        frame = out["frame" + suffix]
        assert frame.shape == (64, 96, 3) and frame.any()
        np.testing.assert_array_equal(frame, one_device_frame(out["loaded" + suffix]))


@pytest.mark.parametrize("which", [7, 8], ids=["after_morton", "after_p3m_step"])
def test_sharded_frames_equal_one_devices(d4, which):
    """4 gloo ranks, after Morton re-sorts (plain route) or a sharded P3M
    step (kernel route): ``render_frame`` with ``auto`` (the sharded render),
    ``host`` and ``device`` (the gathered rows), and each resolve's
    begin/finish around a chunk, equal on every rank and bit-equal to one
    device's frames of the gathered state; the padding stays at the tail."""
    outs = [r[which] for r in d4]
    want = {res: one_device_frame(outs[0]["arrays"], res) for res in ("auto", "host", "device")}
    assert want["auto"].any()
    for out in outs:
        assert out["pad_mass"] == 0.0 and out["step_after"] == out["step"] + 1
        for res in ("auto", "host", "device"):
            np.testing.assert_array_equal(out[res], want[res])
            np.testing.assert_array_equal(out["pipelined " + res], want[res])
        for a, b in zip(out["arrays"], outs[0]["arrays"]):
            np.testing.assert_array_equal(a, b)


def test_regenerate_on_a_mesh_builds_one_state(d4):
    """``regenerate()`` with no seed: rank 0 draws the seed and every rank
    takes it, so the shards are the rows of one global state, the one a
    device builds from that seed."""
    outs = [r[9] for r in d4]
    seeds = {o["seed"] for o in outs}
    assert len(seeds) == 1
    one = Simulation.from_preset("plummer", SimConfig(seed=seeds.pop()), n=600, device="cpu")
    assert outs[0]["n_pad"] % 4 == 0
    full = np.concatenate([o["shard"] for o in outs])
    np.testing.assert_array_equal(full[:600], one.arrays()[0])
    assert not full[600:].any()
    for o in outs:
        np.testing.assert_array_equal(o["arrays"][0], one.arrays()[0])


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
    assert set(info["sharded"]) == {"direct", "pm", "p3m", "render"}
    assert set(info["sharded"]["render"]) == {"auto", "host", "device"}


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


class _OneRankGroup:
    """A gloo process group of this one process (a ``file://`` store), for a
    one-rank mesh in the test process; destroyed on exit."""

    def __init__(self, tmp):
        self.store = f"file://{tmp}/store"

    def __enter__(self):
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=self.store, rank=0, world_size=1)

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def test_sharded_simulation_refuses_to_render(tmp_path):
    """A one-rank mesh (a gloo group of this process): ``render_frame`` and
    ``render_frame_begin``/``finish`` by every resolve equal one device's
    frames of the same state, bit for bit."""
    pm, v = rank_checks.random_bodies(0, 64)
    one = Simulation(SimConfig(backend="jnp"), pm, v, device="cpu")
    cam, frame = rank_checks.frame_camera(), rank_checks.FRAME
    with _OneRankGroup(tmp_path):
        sim = Simulation(SimConfig(backend="jnp"), pm, v, mesh=_fake_mesh((1,)))
        assert sim.device == torch.device("cpu") and sim.n_pad == 64
        for res in ("auto", "host", "device"):
            want = one.render_frame(camera=cam, resolve=res, **frame)
            assert want.any()
            np.testing.assert_array_equal(sim.render_frame(camera=cam, resolve=res, **frame), want)
            handle = sim.render_frame_begin(cam, resolve=res, **frame)
            np.testing.assert_array_equal(sim.render_frame_finish(handle), want)
    with pytest.raises(TypeError, match="device"):
        Simulation(SimConfig(), pm, v)


SERVE_FLAGS = ["--device", "cpu", "--preset", "plummer", "--n", "256", "--backend", "jnp", "--port", "0",
               "--width", "96", "--height", "64", "--steps-per-frame", "2"]


def _url_of(proc, deadline: float) -> str | None:
    """The viewer's URL from ``live viewer at ...`` on ``proc``'s stdout."""
    buf = b""
    while time.monotonic() < deadline and proc.poll() is None:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            chunk = os.read(proc.stdout.fileno(), 4096)
            buf += chunk
            for line in buf.decode(errors="replace").splitlines():
                if line.startswith("live viewer at "):
                    return line.split()[3]
    return None


def _serve_mesh(flag, tmp_path):
    """``serve`` on two gloo ranks: ``--devices 2`` (one command, which spawns
    the ranks) or ``--distributed`` (two processes as ``torchrun`` starts
    them, a free localhost port, taken again on an address-in-use failure).
    Waits for rank 0's URL, fetches ``/frame.jpg`` and ``/stats`` (timeouts
    on every call), then sends SIGINT to every process, as a terminal's
    Ctrl-C does.  Returns (frame, stats, exit codes, stderr)."""
    import socket

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = [sys.executable, "-m", "nbody3d_tpu_torch.cli", "serve", *SERVE_FLAGS]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for _ in range(4):
        if flag == "--devices":
            cmds = [(base + ["--devices", "2"], env)]
        else:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            cmds = [(base + ["--distributed"], dict(env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                                                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
                    for r in range(2)]
        procs = [subprocess.Popen(c, cwd=root, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  start_new_session=True) for c, e in cmds]
        frame = stats = None
        try:
            url = _url_of(procs[0], time.monotonic() + 120)
            if url is not None:
                with urllib.request.urlopen(url + "frame.jpg", timeout=30) as r:
                    frame = r.read()
                with urllib.request.urlopen(url + "stats", timeout=30) as r:
                    stats = json.loads(r.read())
            for p in procs:
                os.killpg(p.pid, signal.SIGINT)
            errs = [p.communicate(timeout=60)[1].decode(errors="replace") for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(10)
        codes = [p.returncode for p in procs]
        if url is not None or not any("address already in use" in e.lower() for e in errs):
            return frame, stats, codes, errs
    return frame, stats, codes, errs


def _checkpoint(tmp_path) -> str:
    assert cli.main(["run", "--preset", "plummer", "--n", "256", "--steps", "2", "--log-every", "2", "--backend",
                     "jnp", "--device", "cpu", "--outdir", str(tmp_path / "ck")]) == 0
    return str(tmp_path / "ck" / "final.npz")


@pytest.mark.parametrize("command", ["animate", "serve"])
@pytest.mark.parametrize("flag", [["--devices", "2"], ["--distributed"]])
def test_cli_rendering_commands_refuse_a_mesh(tmp_path, command, flag):
    """``serve`` serves a mesh with either flag: rank 0 answers
    ``/frame.jpg`` (a JPEG of the frame's size) and ``/stats``, and a
    Ctrl-C stops every rank with exit code 0.  ``animate`` loads on one
    device, as the JAX package's does: ``--devices 2`` writes the frames it
    writes without the flag, and ``--distributed`` is refused with a
    ``ValueError`` before anything loads."""
    if command == "serve":
        frame, stats, codes, errs = _serve_mesh(flag[0], tmp_path)
        assert codes == [0] * len(codes), [e[-2000:] for e in errs]
        assert frame[:2] == b"\xff\xd8" and frame[-2:] == b"\xff\xd9"
        assert stats["n"] == 256 and stats["resolution"] == "96x64"
        return
    if flag == ["--distributed"]:
        with pytest.raises(ValueError, match="one device"):
            cli.main([command, str(tmp_path / "missing.npz"), *flag, "--device", "cpu"])
        return
    ckpt = _checkpoint(tmp_path)
    anim = ["animate", ckpt, "--frames", "3", "--steps-per-frame", "1", "--width", "96", "--height", "64",
            "--device", "cpu"]
    assert cli.main([*anim, *flag, "--outdir", str(tmp_path / "mesh")]) == 0
    assert cli.main([*anim, "--outdir", str(tmp_path / "one")]) == 0
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "mesh")) and len(names) == 3
    for name in names:
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()


def test_cli_run_devices_writes_rank0_frames(tmp_path):
    """``run --devices 2 --device cpu --render-every``: rank 0 writes the
    frames (the sharded render, every rank rendering), and frame 0 is
    bit-equal to the one-device run's."""
    from nbody3d_tpu_torch.render.image import read_png

    flags = ["run", "--preset", "plummer", "--n", "256", "--steps", "2", "--log-every", "2", "--render-every", "2",
             "--backend", "jnp", "--device", "cpu"]
    assert cli.main([*flags, "--devices", "2", "--outdir", str(tmp_path / "mesh")]) == 0
    assert cli.main([*flags, "--outdir", str(tmp_path / "one")]) == 0
    frames = sorted(p for p in os.listdir(tmp_path / "mesh") if p.startswith("frame_"))
    assert frames == ["frame_000000.png", "frame_000001.png"]
    got, want = (read_png(str(tmp_path / d / "frame_000000.png")) for d in ("mesh", "one"))
    assert got.any()
    np.testing.assert_array_equal(got, want)


def test_serve_on_a_mesh_keeps_one_state(tmp_path):
    """Two gloo ranks: rank 0's ``LiveViewer`` driven through pipelined
    frames, a dt change, pause and unpause, regenerate, export and import
    and a last pause, then stopped; rank 1 in ``viewer.follow``.  Both
    ranks took the same op records (the same ops, runtimes, step counts
    and regenerate seed, ``stop`` last), end with the same step, runtime,
    seed and gathered state, and rank 0's last JPEG is the encode of one
    device's frame of that state at its camera."""
    from nbody3d_tpu_torch.render.jpeg import encode_jpeg
    from nbody3d_tpu_torch.utils.camera import Camera

    case = dict(kind="serve", preset="plummer", n=256, config=dict(backend="jnp"))
    r0, r1 = (r[0] for r in spawn(rank_checks.run_cases, 2, [case], device="cpu", timeout=240))
    assert r0["log"] == r1["log"]
    ops = [op for op, *_ in r0["log"]]
    assert ops[-1] == "stop" and ops.count("stop") == 1
    assert {"frame", "render", "regenerate", "export", "import"} <= set(ops)
    assert any(rt is not None and abs(rt[0] - 10 ** -3.8) < 1e-15 for _, rt, _, _ in r0["log"])
    assert all(seed is not None for op, _, _, seed in r0["log"] if op == "regenerate")
    for key in ("runtime", "step", "seed"):
        assert r0[key] == r1[key], key
    for a, b in zip(r0["arrays"], r1["arrays"]):
        np.testing.assert_array_equal(a, b)
    assert r0["runtime"][2] is not None  # paused at the end
    one = Simulation(SimConfig(backend="jnp"), *r0["arrays"], device="cpu")
    img = one.render_frame(camera=Camera.from_dict(r0["camera"]), **rank_checks.FRAME)
    assert img.any() and r0["frame"] == encode_jpeg(img, 85)


def test_serve_on_a_mesh_keeps_one_state_when_a_followers_import_fails():
    """Two gloo ranks, rank 1's import of an uploaded checkpoint fails
    alone: the ranks agree on it, so both keep the running simulation (the
    frame after the import steps on from the frame before it, not from the
    checkpoint's step 0), rank 0's import raises and names the other rank,
    and both end with one state."""
    case = dict(kind="serve_import_fails", preset="plummer", n=256, config=dict(backend="jnp"))
    r0, r1 = (r[0] for r in spawn(rank_checks.run_cases, 2, [case], device="cpu", timeout=240))
    assert r0["raised"] is not None and "another rank" in r0["raised"]
    assert r0["step"] == r1["step"] == 4
    for a, b in zip(r0["arrays"], r1["arrays"]):
        np.testing.assert_array_equal(a, b)


def test_dryrun_multichip_on_four_gloo_ranks():
    """``dryrun_multichip(4, "cpu")``: one sharded step of each of the JAX
    dryrun's seven configurations (the 2-D grid among them at D = 4) and the
    sharded render at 96x64."""
    from nbody3d_tpu_torch.parallel.dryrun import configs, dryrun_multichip

    report = dryrun_multichip(4, "cpu")
    assert report["steps"] == {name: 1 for name in configs(4)} and len(report["steps"]) == 7
    assert report["frame"]["shape"] == [64, 96] and report["frame"]["n_uncovered"] == 0
    assert report["frame"]["lit"] > 0 and len(report["launches_by_rank"]) == 4


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
