"""Checkpoints across the two packages, the engine's frame, and the CLI's
render + checkpoint path, on the CPU.

Files written by one package load in the other bit for bit: the arrays,
the step, the camera dict and the config (npz); the arrays, the step, the
camera and the "G" slider string (reference JSON).  The run's frames and
checkpoints, ``render`` and ``convert`` follow ``nbody3d_tpu/cli.py``, the
resume semantics included (the file's config wins except for the flags
given)."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli  # noqa: E402
from nbody3d_tpu_torch.render.image import read_png  # noqa: E402
from nbody3d_tpu_torch.utils import checkpoint  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402

N = 2000  # two galaxies of 999 disk bodies and a centre each


@pytest.fixture(scope="module")
def sims():
    """A JAX and a port Simulation on one two-galaxy state after 2 steps
    (non-zero lagged accel), with runtime dt/G changed from the config."""
    js = JaxSimulation.from_preset("two-galaxy", JaxConfig(backend="jnp", G=3e-4), n=N, platform="cpu")
    js.run(2, chunk=2)
    js.dt, js.G = 2e-4, 5e-4
    pm, vel, acc = js.arrays()
    ts = Simulation(SimConfig(backend="jnp", G=3e-4), pm, vel, acc, step=js.step_count, device="cpu",
                    camera_target=js.camera_target)
    ts.dt, ts.G = 2e-4, 5e-4
    return js, ts


def assert_same_sim(a, b):
    for x, y in zip(a.arrays(), b.arrays()):
        np.testing.assert_array_equal(x, y)
    assert a.step_count == b.step_count and a.n_real == b.n_real
    np.testing.assert_array_equal(a.camera_target, b.camera_target)
    assert a.dt == b.dt and a.G == b.G


@pytest.mark.parametrize("fmt", ["npz", "json"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_across_packages(sims, tmp_path, fmt, direction):
    js, ts = sims
    path = str(tmp_path / f"c.{fmt}")
    if direction == "jax_to_port":
        js.save(path)
        got = Simulation.load(path, device="cpu")
    else:
        ts.save(path)
        got = JaxSimulation.load(path, platform="cpu")
    src = ts if direction == "jax_to_port" else js
    if fmt == "json":
        # The file stores G as the 2-decimal log10 slider string.
        src_G, src.G = src.G, float(10.0 ** float(f"{np.log10(src.G):.2f}"))
        try:
            assert_same_sim(got, src)
        finally:
            src.G = src_G
    else:
        assert_same_sim(got, src)
        assert got.config.to_json() == src.config.replace(dt=src.dt, G=src.G).to_json()
    assert got.loaded_camera.to_dict() == Camera(target=src.camera_target).to_dict()


def test_files_are_the_same(sims, tmp_path):
    """Both writers put the same keys and values in a file: the JSON
    documents hold the same float32 arrays (spelled with other digits) and
    the same other keys, the "G" string included; the npz arrays and
    config/camera strings are equal."""
    js, ts = sims
    for fmt in ("json", "npz"):
        js.save(str(tmp_path / f"j.{fmt}"))
        ts.save(str(tmp_path / f"t.{fmt}"))
    j, t = (json.loads((tmp_path / f"{w}.json").read_text()) for w in "jt")
    arrays = ("bodies", "vel", "accel")
    for k in arrays:
        np.testing.assert_array_equal(np.float32(j.pop(k)), np.float32(t.pop(k)))
    assert j == t and t["G"] == f"{np.log10(5e-4):.2f}" == "-3.30"
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k])


def test_bad_files_raise(sims, tmp_path):
    _, ts = sims
    ts.save(str(tmp_path / "c.json"))
    doc = json.loads((tmp_path / "c.json").read_text())
    doc["nBodies"] = N + 1
    (tmp_path / "bad.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="nBodies"):
        Simulation.load(str(tmp_path / "bad.json"), device="cpu")
    with pytest.raises(ValueError, match="nBodies"):
        JaxSimulation.load(str(tmp_path / "bad.json"), platform="cpu")
    for bad in ("ckpt_dir", "c.orbax"):
        with pytest.raises(ValueError, match="orbax"):
            ts.save(str(tmp_path / bad))
        with pytest.raises(ValueError, match=".npz"):
            Simulation.load(str(tmp_path / bad), device="cpu")
    assert checkpoint.peek_config(str(tmp_path / "c.json")) is None
    ts.G = 0.0
    try:
        with pytest.raises(ValueError, match="G > 0"):
            ts.save(str(tmp_path / "g0.json"))
    finally:
        ts.G = 5e-4


def test_preset_camera_and_frame_match_jax(sims):
    """The engine keeps the preset's camera target, and its host frame is
    the JAX engine's default frame, bit for bit."""
    js, ts = sims
    fresh = Simulation.from_preset("two-galaxy", SimConfig(), n=N, device="cpu")
    jfresh = JaxSimulation.from_preset("two-galaxy", JaxConfig(backend="jnp"), n=N, platform="cpu")
    np.testing.assert_array_equal(fresh.camera_target, jfresh.camera_target)
    kw = dict(width=320, height=240)
    np.testing.assert_array_equal(ts.render_frame(resolve="host", **kw), js.render_frame(**kw))
    img = ts.render_frame(**kw)  # auto: the device prep, here on the CPU
    assert img.shape == (240, 320, 3) and ts.last_render_ms > 0 and "320x240" in ts.last_render_info
    assert (img == js.render_frame(**kw)).all(axis=2).mean() > 0.999
    assert any("render_ms" in line for line in ts.log_lines())


def test_cli_run_render_convert(tmp_path, capsys):
    out = tmp_path / "out"
    args = ["--device", "cpu", "--preset", "uniform-sphere", "--n", "256", "--log-every", "2",
            "--checkpoint-every", "4", "--render-every", "2", "--outdir", str(out), "--dt", "2e-4"]
    assert cli.main(["run", "--steps", "4", "--diagnostics", "--log-G", "-3", *args]) == 0
    text = capsys.readouterr().out
    assert "render_ms=" in text and "checkpoint ->" in text and "E=" in text
    names = sorted(p.name for p in out.iterdir())
    assert names == ["ckpt_00000004.npz", "final.npz", "frame_000000.png", "frame_000001.png",
                     "frame_000002.png"]
    last = read_png(str(out / "frame_000002.png"))
    assert last.shape == (768, 1024, 3) and last.any()

    assert cli.main(["render", str(out / "final.npz"), "-o", str(tmp_path / "r.png"), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(read_png(str(tmp_path / "r.png")), last)
    small = tmp_path / "s.png"
    assert cli.main(["render", str(out / "final.npz"), "-o", str(small), "--device", "cpu", "--width", "64",
                     "--height", "48", "--color-mode", "direction", "--resolve", "host"]) == 0
    assert read_png(str(small)).shape == (48, 64, 3)

    assert cli.main(["convert", str(out / "final.npz"), str(tmp_path / "x.json"), "--device", "cpu"]) == 0
    assert cli.main(["convert", str(tmp_path / "x.json"), str(tmp_path / "y.npz"), "--device", "cpu"]) == 0
    with np.load(out / "final.npz") as a, np.load(tmp_path / "y.npz") as b:
        for k in ("pos_mass", "vel", "accel", "step"):
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="orbax"):
        cli.main(["convert", str(out / "final.npz"), str(tmp_path / "dir"), "--device", "cpu"])


def test_cli_resume_semantics(tmp_path):
    """Resuming keeps the checkpoint's config (dt, G, integrator, seed...)
    except for the flags given, as nbody3d_tpu/cli.py:178-248; a JSON
    checkpoint brings its own G and dt."""
    first = tmp_path / "a"
    assert cli.main(["run", "--device", "cpu", "--preset", "uniform-sphere", "--n", "128", "--steps", "2",
                     "--log-every", "2", "--outdir", str(first), "--dt", "2e-4", "--G", "3e-4",
                     "--integrator", "euler", "--seed", "5"]) == 0
    second = tmp_path / "b"
    assert cli.main(["run", "--device", "cpu", "--checkpoint", str(first / "final.npz"), "--steps", "2",
                     "--log-every", "2", "--outdir", str(second), "--log-G", "-3"]) == 0
    cfg = checkpoint.peek_config(str(second / "final.npz"))
    assert (cfg.dt, cfg.G, cfg.integrator, cfg.seed) == (2e-4, 1e-3, "euler", 5)
    with np.load(second / "final.npz") as z:
        assert int(z["step"]) == 4

    assert cli.main(["convert", str(first / "final.npz"), str(tmp_path / "a.json"), "--device", "cpu"]) == 0
    third = tmp_path / "c"
    assert cli.main(["run", "--device", "cpu", "--checkpoint", str(tmp_path / "a.json"), "--steps", "2",
                     "--log-every", "2", "--outdir", str(third)]) == 0
    cfg = checkpoint.peek_config(str(third / "final.npz"))
    assert cfg.dt == 2e-4 and cfg.G == pytest.approx(10**-3.52) and cfg.integrator == "verlet"
    fourth = tmp_path / "d"
    assert cli.main(["run", "--device", "cpu", "--checkpoint", str(tmp_path / "a.json"), "--steps", "2",
                     "--log-every", "2", "--outdir", str(fourth), "--dt", "1e-4", "--G", "2e-4"]) == 0
    cfg = checkpoint.peek_config(str(fourth / "final.npz"))
    assert (cfg.dt, cfg.G) == (1e-4, 2e-4)
