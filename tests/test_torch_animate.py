"""Animations without an image library (``render/image.py``) and
``cli animate``, on the CPU, held against PIL and the JAX package.

- APNG: the frames PIL decodes equal the inputs bit for bit, as do the
  port's own :func:`read_apng`'s; :func:`read_png` reads the first frame.
- GIF: the frames PIL decodes are within, per channel, the mean absolute
  error of the JAX package's ``save_animation`` GIF of the same frames
  (PIL's adaptive palette) plus 2; the LZW core (``native/_image.c``'s
  ``nb_gif_lzw``) gives its Python twin's bytes.
- ``.mp4`` without ffmpeg raises the JAX package's message.
- ``cli animate`` writes the JAX CLI's frame sequence (the port's device
  prep against the JAX host prep: lit pixels and colours equal on >= 99.9%,
  the bar of ``tests/test_torch_render.py``) and its video.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
PIL_Image = pytest.importorskip("PIL.Image")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from PIL import ImageSequence  # noqa: E402

from nbody3d_tpu import cli as jax_cli  # noqa: E402
from nbody3d_tpu.render import image as jax_image  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli  # noqa: E402
from nbody3d_tpu_torch.render import image, rasterize  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402


def sim_frames(count=4, width=96, height=80):
    """Frames of a two-galaxy run under an orbiting camera."""
    sim = Simulation.from_preset("two-galaxy", SimConfig(backend="jnp"), n=400, device="cpu")
    cam = Camera(target=sim.camera_target, radius=3.0)
    out = []
    for _ in range(count):
        out.append(sim.render_frame(cam, width=width, height=height))
        cam.orbit(40.0, 5.0)
    return out


def gradient_frames(count=3, width=96, height=80):
    yy, xx = np.mgrid[0:height, 0:width]
    return [np.stack([(xx * 2.6 + 9 * i), yy * 3.1, (xx + yy + 7 * i) * 1.4], -1).clip(0, 255).astype(np.uint8)
            for i in range(count)]


def noise_frames(count=2, width=64, height=48, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (height, width, 3), dtype=np.uint8) for _ in range(count)]


SETS = {"two-galaxy": sim_frames, "gradient": gradient_frames, "noise": noise_frames}


def pil_frames(path):
    return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(PIL_Image.open(path))]


@pytest.mark.parametrize("name", list(SETS))
def test_apng_round_trips_bit_for_bit(name, tmp_path):
    frames = SETS[name]()
    path = str(tmp_path / "a.apng")
    image.save_animation(frames, path, fps=12)
    got = pil_frames(path)
    assert len(got) == len(frames)
    assert all(np.array_equal(g, f) for g, f in zip(got, frames))
    assert all(np.array_equal(g, f) for g, f in zip(image.read_apng(path), frames))
    np.testing.assert_array_equal(image.read_png(path), frames[0])
    assert PIL_Image.open(path).info.get("duration") == round(1000 / 12)


def test_apng_from_png_paths(tmp_path):
    frames = sim_frames(count=2)
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.png"))
        image.save_png(paths[-1], f)
    image.save_animation(paths, str(tmp_path / "a.png"), fps=30)
    assert all(np.array_equal(g, f) for g, f in zip(pil_frames(str(tmp_path / "a.png")), frames))
    with pytest.raises(ValueError, match="differ in size"):
        image.save_animation([frames[0], frames[0][:10]], str(tmp_path / "b.apng"))


@pytest.mark.parametrize("name", list(SETS))
def test_gif_error_within_jax_gif_plus_2(name, tmp_path):
    frames = SETS[name]()
    image.save_animation(frames, str(tmp_path / "port.gif"), fps=10)
    jax_image.save_animation(frames, str(tmp_path / "jax.gif"), fps=10)
    ours, theirs = pil_frames(str(tmp_path / "port.gif")), pil_frames(str(tmp_path / "jax.gif"))
    assert len(ours) == len(theirs) == len(frames)
    for o, t, f in zip(ours, theirs, frames):
        mae_o = np.abs(o.astype(int) - f).mean(axis=(0, 1))
        mae_t = np.abs(t.astype(int) - f).mean(axis=(0, 1))
        assert (mae_o <= mae_t + 2).all(), (mae_o, mae_t)
    assert PIL_Image.open(str(tmp_path / "port.gif")).info.get("loop") == 0


@pytest.mark.parametrize("name", list(SETS))
def test_gif_c_core_equals_python_twin(name, tmp_path):
    """The LZW streams of the frames' palette indices, and the file's data
    sub-blocks carry them."""
    frames = SETS[name]()
    image.save_gif(str(tmp_path / "c.gif"), frames, duration_ms=50)
    data = (tmp_path / "c.gif").read_bytes()
    for f in frames:
        code = image.lzw_python(image.median_cut(f)[1])
        assert image._lzw_c(image.median_cut(f)[1]) == code
        assert b"".join(bytes([len(code[i:i + 255])]) + code[i:i + 255] for i in range(0, len(code), 255)) in data


@pytest.mark.parametrize("case", ["empty", "one", "runs", "random", "table-fills"])
def test_lzw_core_equals_twin(case):
    rng = np.random.default_rng(3)
    idx = {
        "empty": np.zeros(0, np.uint8),
        "one": np.array([7], np.uint8),
        "runs": np.repeat(np.arange(256, dtype=np.uint8), 37),
        "random": rng.integers(0, 256, 5000).astype(np.uint8),
        # enough distinct strings to fill the 4,096-code table several times
        "table-fills": rng.integers(0, 256, 40000).astype(np.uint8),
    }[case]
    assert image._lzw_c(idx) == image.lzw_python(idx)


def test_median_cut_palette():
    few = gradient_frames(count=1, width=8, height=4)[0]  # 32 colours: kept exactly
    pal, idx = image.median_cut(few)
    np.testing.assert_array_equal(pal[idx], few)
    many = noise_frames(count=1)[0]
    pal, idx = image.median_cut(many)
    assert len(pal) == 256 and idx.shape == many.shape[:2]
    err = np.abs(pal[idx].astype(int) - many).mean()
    assert err < 20, err  # noise: 256 boxes over 3,072 random colours


def test_video_needs_ffmpeg(tmp_path, monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg not found on PATH"):
        image.save_animation(sim_frames(count=1), str(tmp_path / "a.mp4"))
    with pytest.raises(ValueError, match="unsupported animation format"):
        image.save_animation(sim_frames(count=1), str(tmp_path / "a.avi"))
    with pytest.raises(ValueError, match="no frames"):
        image.save_animation([], str(tmp_path / "a.gif"))


def test_cli_animate_against_jax(tmp_path):
    run = ["run", "--device", "cpu", "--preset", "two-galaxy", "--n", "400", "--steps", "2", "--log-every", "2",
           "--backend", "jnp", "--outdir", str(tmp_path / "run")]
    assert cli.main(run) == 0
    ckpt = str(tmp_path / "run" / "final.npz")
    common = [ckpt, "--frames", "4", "--orbit-degrees", "90", "--width", "96", "--height", "80",
              "--steps-per-frame", "1"]
    assert cli.main(["animate", *common, "--device", "cpu", "--backend", "jnp", "--outdir", str(tmp_path / "port"),
                     "--video", str(tmp_path / "port" / "a.apng")]) == 0
    assert jax_cli.main(["animate", *common, "--backend", "jnp", "--outdir", str(tmp_path / "jax")]) == 0
    for i in range(4):
        ours = image.read_png(str(tmp_path / "port" / f"frame_{i:06d}.png"))
        theirs = np.asarray(PIL_Image.open(tmp_path / "jax" / f"frame_{i:06d}.png").convert("RGB"))
        assert ours.any()
        assert (ours.any(axis=2) == theirs.any(axis=2)).mean() >= 0.999
        assert (ours == theirs).all(axis=2).mean() >= 0.999
    video = image.read_apng(str(tmp_path / "port" / "a.apng"))
    assert len(video) == 4
    for i, f in enumerate(video):
        np.testing.assert_array_equal(f, image.read_png(str(tmp_path / "port" / f"frame_{i:06d}.png")))
    assert cli.main(["animate", ckpt, "--device", "cpu", "--frames", "2", "--width", "64", "--height", "48",
                     "--outdir", str(tmp_path / "gif"), "--video", str(tmp_path / "gif" / "a.gif")]) == 0
    assert len(pil_frames(str(tmp_path / "gif" / "a.gif"))) == 2


def test_resolve_device_frame_in_animation(tmp_path):
    """The quantized frame (``render_points(resolve="device")``) in a GIF."""
    sim = Simulation.from_preset("two-galaxy", SimConfig(backend="jnp"), n=400, device="cpu")
    frame = rasterize.render_points(sim.state.pos_mass[: sim.n_real], sim.state.vel[: sim.n_real],
                                    Camera(target=sim.camera_target), width=64, height=48, resolve="device")
    image.save_animation([frame, frame], str(tmp_path / "d.apng"))
    assert all(np.array_equal(g, frame) for g in pil_frames(str(tmp_path / "d.apng")))
