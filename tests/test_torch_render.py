"""The port's renderer on the CPU against the JAX package's.

- The resolve twin (what ``splat_resolve`` runs on CPU tensors) against
  ``resolve_all_pallas`` in interpret mode, both fed the JAX device prep's
  arrays: the rgb and depth planes bit-identical (the JAX package's own
  bar between its resolves, ``tests/test_render.py:312-430``).
- The twin against ``native/_raster.c`` on adversarial radii, and its two
  regimes against each other: bit-identical.
- ``render_points(resolve="host")`` against the JAX default frame:
  bit-identical.
- The device prep against ``_project_f32``: ``cx``/``cy`` equal on >= 99.99%
  of visible bodies, ``r`` rtol 1e-6, depth bits within 4 ulp (torch has no
  cbrt and sums in its own order); its frame against the JAX "pallas" frame
  on >= 99.9% of pixels (the JAX package's bar between its two preps,
  ``tests/test_render.py:202-203``).
- ``Camera``/``mathlib`` against the JAX ones, rtol 1e-12; PNG files.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from nbody3d_tpu import native  # noqa: E402
from nbody3d_tpu.render import rasterize as jax_raster  # noqa: E402
from nbody3d_tpu.render.pallas_resolve import resolve_all_pallas  # noqa: E402
from nbody3d_tpu.utils import mathlib as jax_mathlib  # noqa: E402
from nbody3d_tpu.utils.camera import Camera as JaxCamera  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.render import rasterize, resolve  # noqa: E402
from nbody3d_tpu_torch.render.image import read_png, save_png  # noqa: E402
from nbody3d_tpu_torch.utils import mathlib  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402


def scene(n, seed, *, scale=2.5, heavy=2, masses=None):
    """tests/test_render.py's scenes: bodies N(0, scale), masses
    U(10, 50), the first ``heavy`` at 1e7 (or ``masses``), velocities
    N(0, 5)."""
    rng = np.random.default_rng(seed)
    pos_mass = np.concatenate(
        [rng.normal(scale=scale, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    if masses is not None:
        pos_mass[: len(masses), 3] = masses
    elif heavy:
        pos_mass[:heavy, 3] = 1e7
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    return pos_mass, vel


# name: (scene kwargs, camera radius, frame kwargs).  The scenes of
# tests/test_render.py:312-430.
SCENES = {
    "dense_20k": (dict(n=20_000, seed=13), 4.0, dict(width=320, height=240)),
    "bin_edges": (dict(n=6_000, seed=7, heavy=0), 2.0, dict(width=640, height=100)),
    "tier3_radii": (dict(n=3_000, seed=11, scale=2.0, masses=np.geomspace(1e5, 5e9, 64)), 2.0,
                    dict(width=320, height=240)),
    "max_radius_96": (dict(n=1_500, seed=12, scale=2.0, masses=[5e10] * 4), 2.0,
                      dict(width=256, height=160, max_radius_px=96)),
}
# size_factor: tests/test_render.py's four (every radius clamped to 0.5 px
# at this frame height), then three whose radii start just below r = 1,
# sqrt 2 and 2 (the least radius is about 160 / sf) and cross that edge.
SWEEP = [400.0, 700.0, 1000.0, 1800.0, 160.2, 113.3, 80.2]


def jax_prep(pos_mass, vel, cam, width, height, size_factor=1000.0, max_radius_px=64):
    out = jax_raster._prep_device_unsorted_raw(
        pos_mass, vel, JaxCamera.from_dict(cam.to_dict()), width, height,
        size_factor, max_radius_px, "magnitude")
    return [np.asarray(jax.device_get(a)) for a in out]


def twin_buffer(prep, width, height, keep=None):
    cx, cy, depth_bits, rgb24, r, visible = prep
    if keep is not None:
        visible = visible & keep
    t = [torch.from_numpy(np.array(a)) for a in (cx, cy, depth_bits.view(np.int32), rgb24.view(np.int32), r, visible)]
    return resolve.splat_resolve(*t, width=width, height=height)


def assert_planes_equal(buf, rgb_u32, depth, width, height):
    rgb, d = resolve.buffer_planes(buf, width=width, height=height)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(rgb_u32).astype(np.int64))
    np.testing.assert_array_equal(d.numpy().view(np.int32), np.asarray(depth, np.float32).view(np.int32))


def _twin_vs_pallas(pos_mass, vel, cam, frame, size_factor=1000.0):
    width, height = frame["width"], frame["height"]
    rmax = frame.get("max_radius_px", 64)
    prep = jax_prep(pos_mass, vel, cam, width, height, size_factor, rmax)
    rgb_u32, depth, n_host = resolve_all_pallas(
        *[jax.numpy.asarray(a) for a in prep], width=width, height=height, interpret=True)
    # resolve_all_pallas covers r <= 64 and counts the rest in n_host.
    buf = twin_buffer(prep, width, height, keep=prep[4] <= 64.0)
    assert_planes_equal(buf, rgb_u32, depth, width, height)
    assert (buf != resolve.MISS).sum() > 50
    return prep, int(n_host), rgb_u32


@pytest.mark.parametrize("name", list(SCENES))
def test_twin_matches_pallas_resolve(name):
    """The twin against resolve_all_pallas (interpret) on the JAX device
    prep's arrays: bit-identical planes; every splat drawn, r > 64 too."""
    scene_kw, radius, frame = SCENES[name]
    pos_mass, vel = scene(**scene_kw)
    cam = Camera(target=np.zeros(3), radius=radius)
    prep, n_host, _ = _twin_vs_pallas(pos_mass, vel, cam, frame)
    r, vis = prep[4], prep[5]
    if name == "tier3_radii":
        assert ((r >= 16) & (r <= 64) & vis).sum() > 0 and n_host == 0
    if name == "max_radius_96":
        # Beyond the TPU tiers: the JAX package stamps these on the host.
        assert n_host > 0
        width, height = frame["width"], frame["height"]
        want = jax_raster.render_points(pos_mass, vel, JaxCamera(target=np.zeros(3), radius=radius),
                                        prep="device", **frame)
        img = resolve.buffer_image(twin_buffer(prep, width, height), width=width, height=height)
        np.testing.assert_array_equal(img.numpy(), want)


@pytest.mark.parametrize("size_factor", SWEEP)
def test_twin_matches_pallas_at_radius_thresholds(size_factor):
    """Radii swept across the r = 1, sqrt(2), 2 inclusion edges."""
    pos_mass, vel = scene(512, 3, scale=1.0, heavy=0)
    cam = Camera(target=np.zeros(3), radius=5.0)
    _twin_vs_pallas(pos_mass, vel, cam, dict(width=200, height=160), size_factor)


def test_twin_matches_native_on_adversarial_radii():
    """Radii next to square roots of integers and next to integers (in f64
    the disc's rows stop at floor(r) while r*r may round up to the next
    square): the twin's frame is native/_raster.c's, word for word."""
    if native.raster is None:
        pytest.skip("the JAX package's native raster module is not built here")
    rng = np.random.default_rng(4)
    n, w, h = 600, 96, 80
    base = np.concatenate([np.sqrt(np.arange(1, 201, dtype=np.float64)), np.arange(1.0, 101.0)])
    r = rng.choice(base, n) * (1.0 + rng.choice([-1, 0, 1], n) * 2.0**-52)
    r = np.clip(r, 0.5, 40.0)
    cx = rng.integers(-10, w + 10, n).astype(np.int64)
    cy = rng.integers(-10, h + 10, n).astype(np.int64)
    keys = (rng.integers(0, 1 << 30, n).astype(np.uint64) << np.uint64(32)) | rng.integers(0, 1 << 24, n).astype(
        np.uint64)
    want = np.full(w * h, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    native.raster.stamp_discs(want, h, w, cx, cy, r, keys)
    got = resolve.resolve_keys_plain(torch.from_numpy(cx), torch.from_numpy(cy),
                                     torch.from_numpy(keys.view(np.int64)), torch.from_numpy(r), width=w, height=h)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int64))


@pytest.mark.parametrize("small_max", [0, 10**9])
def test_twin_regimes_agree(small_max, monkeypatch):
    """The per-splat stamp and the offset loop give the same frame: all
    splats down one path, then the other, against the mixed default."""
    pos_mass, vel = scene(3_000, 11, scale=2.0, masses=np.geomspace(1e5, 5e9, 64))
    cam = Camera(target=np.zeros(3), radius=2.0)
    kw = dict(width=160, height=120)
    mixed = rasterize.render_buffer(pos_mass, vel, cam, **kw)
    monkeypatch.setattr(resolve, "SMALL_MAX", small_max)
    assert torch.equal(rasterize.render_buffer(pos_mass, vel, cam, **kw), mixed)


@pytest.mark.parametrize("color_mode", ["magnitude", "direction"])
def test_host_frame_matches_jax_default(color_mode):
    """resolve="host" is the JAX package's default frame, bit for bit."""
    pos_mass, vel = scene(20_000, 13)
    kw = dict(width=320, height=240, color_mode=color_mode)
    got = rasterize.render_points(pos_mass, vel, Camera(target=np.zeros(3), radius=4.0), resolve="host", **kw)
    want = jax_raster.render_points(pos_mass, vel, JaxCamera(target=np.zeros(3), radius=4.0), **kw)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=2) > 0).sum() > 1000


def test_device_prep_matches_project_f32():
    pos_mass, vel = scene(20_000, 9)
    cam = Camera(target=np.zeros(3), radius=5.0)
    want = jax_prep(pos_mass, vel, cam, 320, 240)
    got = [t.numpy() for t in rasterize.prep_device(torch.from_numpy(pos_mass), torch.from_numpy(vel), cam, 320, 240)]
    vis = want[5]
    assert (got[5] == vis).mean() >= 0.9999 and vis.sum() > 10_000
    both = vis & got[5]
    for c in (0, 1):
        assert (got[c][both] == want[c][both]).mean() >= 0.9999
    np.testing.assert_allclose(got[4][both], want[4][both], rtol=1e-6)
    ulps = np.abs(got[2][both].astype(np.int64) - want[2][both].view(np.int32).astype(np.int64))
    assert ulps.max() <= 4
    assert (got[3][both] == want[3][both].view(np.int32)).mean() >= 0.9999


def test_device_prep_frame_matches_jax_pallas_frame():
    """The port's "auto" frame (device prep + resolve; the twin on a CPU
    state) against the JAX "pallas" frame."""
    pos_mass, vel = scene(20_000, 13)
    cam = Camera(target=np.zeros(3), radius=4.0)
    frame = dict(width=320, height=240)
    _, n_host, rgb_u32 = _twin_vs_pallas(pos_mass, vel, cam, frame)
    assert n_host == 0
    rgb_u32 = np.asarray(rgb_u32).astype(np.int64)
    want = np.where((rgb_u32 == 0xFFFFFFFF)[..., None], 0,
                    (rgb_u32[..., None] >> np.array([16, 8, 0])) & 0xFF).astype(np.uint8)
    got = rasterize.render_points(torch.from_numpy(pos_mass), torch.from_numpy(vel), cam, **frame)
    agree = (got == want).all(axis=2).mean()
    assert agree >= 0.999, agree


def test_resolve_choices_and_wrapper_checks():
    reset_launch_counts()
    pos_mass, vel = scene(200, 1)
    cam = Camera(target=np.zeros(3))
    img = rasterize.render_points(pos_mass, vel, cam, width=64, height=48)
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8 and img.any()
    assert all(c == 0 for c in launch_counts().values())  # CPU tensors: the twin
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rasterize.render_points(pos_mass, vel, cam, width=64, height=48, resolve="device")
    with pytest.raises(ValueError, match="unknown resolve"):
        rasterize.render_points(pos_mass, vel, cam, width=64, height=48, resolve="native")
    prep = rasterize.prep_device(torch.from_numpy(pos_mass), torch.from_numpy(vel), cam, 64, 48)
    with pytest.raises(TypeError, match="cx must be torch.int32"):
        resolve.splat_resolve(prep[0].long(), *prep[1:], width=64, height=48)
    with pytest.raises(ValueError, match="length"):
        resolve.splat_resolve(*prep[:4], prep[4][:10], prep[5], width=64, height=48)
    # An empty scene and one behind the camera: the background only.
    empty = resolve.splat_resolve(*(t[:0] for t in prep), width=64, height=48)
    assert (empty == resolve.MISS).all()
    behind = np.array([[0, 0, 100.0, 1e6]], np.float32)
    assert not rasterize.render_points(behind, np.zeros((1, 4), np.float32), cam, width=32, height=32).any()


def test_single_body_renders_centered_disc():
    """tests/test_render.py's single-body check through the port's auto frame."""
    cam = Camera(target=np.zeros(3), radius=5.0)
    img = rasterize.render_points(np.array([[0, 0, 0, 1e6]], np.float32), np.zeros((1, 4), np.float32), cam,
                                  width=256, height=256, background=(1, 2, 3))
    center = img[128, 128]
    assert center[2] == 255 and center[1] in (127, 128) and center[0] == 0
    assert tuple(img[0, 0]) == (1, 2, 3) and (img.sum(axis=2) > 6).sum() > 4


def test_camera_and_mathlib_match_jax():
    rng = np.random.default_rng(6)
    for _ in range(20):
        kw = dict(target=rng.normal(size=3), radius=float(rng.uniform(0.5, 50)),
                  azimuth=float(rng.uniform(-np.pi, np.pi)), elevation=float(rng.uniform(-1.5, 1.5)),
                  fov=float(rng.uniform(0.2, 2.0)))
        a, b = Camera(**kw), JaxCamera(**kw)
        aspect = float(rng.uniform(0.5, 2.5))
        for x, y in ((a.position, b.position), (a.view_proj(aspect)[0], b.view_proj(aspect)[0])):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
        assert a.view_proj(aspect)[1] == b.view_proj(aspect)[1]
        assert a.to_dict() == b.to_dict() and a.describe() == b.describe()
        assert Camera.from_dict(b.to_dict()).to_dict() == b.to_dict()
        for op, args in (("orbit", (3.0, -2.0)), ("pan", (5.0, 7.0)), ("zoom", (0.1,)), ("adj_fov_without_zoom", (0.05,))):
            getattr(a, op)(*args)
            getattr(b, op)(*args)
        np.testing.assert_allclose(a.position, b.position, rtol=1e-12)
        eye, up = rng.normal(size=3) * 5, np.array([0.0, 1.0, 0.0])
        np.testing.assert_allclose(mathlib.look_at(eye, kw["target"], up), jax_mathlib.look_at(eye, kw["target"], up),
                                   rtol=1e-12)
        p = (kw["fov"], aspect, 0.1, 1e5)
        np.testing.assert_allclose(mathlib.perspective(*p), jax_mathlib.perspective(*p), rtol=1e-12)
        m = rng.normal(size=(4, 4)).astype(np.float32)
        np.testing.assert_array_equal(mathlib.from_column_major(mathlib.to_column_major(m)), m)
        np.testing.assert_array_equal(mathlib.to_column_major(m), jax_mathlib.to_column_major(m))


def test_png_round_trip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img[2, 3] = [255, 10, 20]
    save_png(str(tmp_path / "f.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.png")), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")), img)
    Image.fromarray(np.dstack([img, img[..., :1]]), mode="RGBA").save(tmp_path / "rgba.png")
    with pytest.raises(ValueError, match="8-bit RGB"):
        read_png(str(tmp_path / "rgba.png"))
