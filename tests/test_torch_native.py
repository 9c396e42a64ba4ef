"""The port's host C modules against the JAX package's, on the CPU.

``nbody3d_tpu_torch/native/_raster.c`` (the disc stamp of the ``host``
frame and of the quantized frame's large splats) bit for bit against the
JAX package's ``native/_raster.c``, its numpy resolve and the port's torch
twins; ``native/_fastjson.c`` (the float32 JSON codec) through the
reference-JSON checkpoint: the port's file byte for byte the JAX
package's, finite and not, and the scanner's arrays those of
``json.loads``.  A compiler that fails raises on every path."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu import native as jax_native  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.render import rasterize as jax_raster  # noqa: E402
from nbody3d_tpu.utils.camera import Camera as JaxCamera  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, _build, native, scatter_checks  # noqa: E402
from nbody3d_tpu_torch.render import rasterize, resolve  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _words(rng, n, top=1 << 30):
    return (rng.integers(0, top, n).astype(np.uint64) << np.uint64(32)) | rng.integers(0, 1 << 24, n).astype(np.uint64)


def _neighbours(x: np.ndarray) -> np.ndarray:
    """Each float64 and the floats either side of it."""
    return np.concatenate([np.nextafter(x, -np.inf), x, np.nextafter(x, np.inf)])


def stamp_scenes() -> dict:
    """name: ``(cx, cy, r, keys, width, height, prefilled)``: int64 centres,
    float64 radii, uint64 words, and whether the buffer already holds
    words (else all ones)."""
    rng = np.random.default_rng(21)
    out = {}
    for name, (cx, cy, depth, rgb, r, vis, w, h) in scatter_checks.resolve_adversarial().items():
        keys = (depth[vis].view(np.uint32).astype(np.uint64) << np.uint64(32)) | rgb[vis].view(np.uint32).astype(
            np.uint64)
        out[name] = (cx[vis].astype(np.int64), cy[vis].astype(np.int64), r[vis].astype(np.float64), keys, w, h, False)
    w, h, n = 96, 80, 500
    centres = (rng.integers(-10, w + 10, n), rng.integers(-10, h + 10, n))
    out["centres off the frame"] = (rng.integers(-90, w + 90, n), rng.integers(-90, h + 90, n),
                                    rng.uniform(0.5, 60.0, n), _words(rng, n), w, h, False)
    out["integer radii"] = (*centres, rng.integers(0, 41, n).astype(np.float64), _words(rng, n), w, h, False)
    # sqrt(m) rounded to float64 lies either side of the root, so r * r
    # rounds onto m or past it: the rows where sqrt alone would miss or
    # add a pixel and the guard loops decide.
    roots = _neighbours(np.sqrt(np.arange(1, 1601, dtype=np.float64)))
    out["r = sqrt(m) and its neighbours"] = (*centres, rng.choice(roots, n), _words(rng, n), w, h, False)
    # Alone on the frame, so no other disc hides a pixel: radii whose r * r
    # lands so that sqrt(r*r - dy*dy) rounds up onto an integer the mask
    # test refuses (sqrt(97) at dy = 4 gives 9, but 9^2 + 4^2 > r*r): the
    # rows that the guard loops correct.  (Below 6 px see
    # test_jax_numpy_resolve_takes_hypot_below_6px.)
    guard = np.array([np.sqrt(97.0), *np.nextafter(np.sqrt([82.0, 117.0, 290.0]), 0)])
    out["r*r just below dx^2 + dy^2, alone"] = (np.arange(25, 200, 45), np.full(4, 40), guard, _words(rng, 4), 200,
                                                80, False)
    below = _neighbours(np.arange(1.0, 41.0))
    out["integers and the floats either side"] = (*centres, rng.choice(below, n), _words(rng, n), w, h, False)
    r0 = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0.0, 3.0, n))
    out["r = 0"] = (*centres, r0, _words(rng, n), w, h, False)
    out["a disc larger than the frame"] = (np.array([40, 5, 90]), np.array([30, -20, 100]),
                                           np.array([150.0, 300.5, 128.0]), _words(rng, 3), w, h, False)
    out["a buffer that already holds words"] = (*centres, rng.uniform(0.5, 20.0, n), _words(rng, n), w, h, True)
    return out


STAMP = stamp_scenes()


def prefill(w, h, prefilled):
    if not prefilled:
        return np.full(w * h, ALL_ONES, np.uint64)
    rng = np.random.default_rng(3)
    buf = _words(rng, w * h)
    buf[rng.random(w * h) < 0.3] = np.uint64(0x7FFFFFFFFFFFFFFF)  # below 2^63, as the torch twin needs
    return buf


@pytest.mark.parametrize("name", list(STAMP))
def test_stamp_matches_jax_and_the_twins(name):
    """``nb_stamp_discs`` bit for bit against the JAX package's
    ``stamp_discs`` and ``_resolve_numpy`` and against the port's twins
    (``resolve_keys_plain`` on an all-ones buffer, ``_stamp_large`` on one
    already holding words)."""
    if jax_native.raster is None:
        pytest.skip("the JAX package's native raster module is not built here")
    cx, cy, r, keys, w, h, prefilled = STAMP[name]
    cx, cy = np.asarray(cx, np.int64), np.asarray(cy, np.int64)
    start = prefill(w, h, prefilled)
    got = torch.from_numpy(start.view(np.int64).copy())
    native.stamp_discs(got, h, w, cx, cy, r, keys)
    want = start.copy()
    jax_native.raster.stamp_discs(want, h, w, cx, cy, r, keys)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    order = np.argsort(-r, kind="stable")  # _resolve_numpy takes the splats radius-descending
    numpy_buf = start.copy()
    jax_raster._resolve_numpy(numpy_buf, cx[order], cy[order], keys[order], r[order], h, w)
    np.testing.assert_array_equal(numpy_buf, want)
    if prefilled:
        twin = torch.from_numpy(start.view(np.int64).copy())  # every word below 2^63: int64 order is theirs
        resolve._stamp_large(twin.view(h, w), *(torch.from_numpy(a) for a in (cx, cy, keys.view(np.int64))), r)
    else:
        twin = resolve.resolve_keys_plain(*(torch.from_numpy(a) for a in (cx, cy, keys.view(np.int64), r)),
                                          width=w, height=h)
    np.testing.assert_array_equal(twin.numpy(), got.numpy())
    assert (want != start).sum() > 0


def test_jax_numpy_resolve_takes_hypot_below_6px():
    """Where they differ, the C stamp is the JAX package's default frame
    (its native resolve), not its numpy fallback: that fallback admits a
    small splat's pixel by ``hypot(dx, dy) <= r`` (r <= 6), which for r =
    sqrt(26) in float64 takes (5, 1), whose 5^2 + 1^2 = 26 is above r * r.
    The port's C stamp and its twins take ``dx^2 + dy^2 <= r * r`` at every
    radius, as the JAX native resolve does."""
    r = np.sqrt([26.0, 29.0])
    cx, cy, keys, w, h = np.array([16, 48]), np.array([16, 16]), np.array([5, 7], np.uint64), 64, 32
    got = torch.full((w * h,), -1, dtype=torch.int64)
    native.stamp_discs(got, h, w, cx, cy, r, keys)
    want = np.full(w * h, ALL_ONES, np.uint64)
    jax_native.raster.stamp_discs(want, h, w, cx, cy, r, keys)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    twin = resolve.resolve_keys_plain(*(torch.from_numpy(a) for a in (cx, cy, keys.view(np.int64), r)), width=w,
                                      height=h)
    assert torch.equal(twin, got)
    fallback = np.full(w * h, ALL_ONES, np.uint64)
    jax_raster._resolve_numpy(fallback, cx[::-1].copy(), cy, keys[::-1].copy(), r[::-1].copy(), h, w)
    lit, lit_fallback = want != ALL_ONES, fallback != ALL_ONES
    assert lit.sum() == 81 + 89 and lit_fallback.sum() == lit.sum() + 16 and not (lit & ~lit_fallback).any()


def test_stamp_takes_numpy_words_and_refuses_bad_input():
    cx, cy, r, keys, w, h, _ = STAMP["integer radii"]
    a = np.full(w * h, ALL_ONES, np.uint64)
    native.stamp_discs(a, h, w, cx, cy, r, keys)
    b = torch.full((w * h,), -1, dtype=torch.int64)
    native.stamp_discs(b, h, w, torch.from_numpy(cx), torch.from_numpy(cy), torch.from_numpy(r),
                       torch.from_numpy(keys.view(np.int64)))
    np.testing.assert_array_equal(a.view(np.int64), b.numpy())
    with pytest.raises(TypeError, match="r must be float64"):
        native.stamp_discs(b, h, w, cx, cy, r.astype(np.float32), keys)
    with pytest.raises(TypeError, match="cx must be int64"):
        native.stamp_discs(b, h, w, cx.astype(np.int32), cy, r, keys)
    with pytest.raises(ValueError, match="cy must have length"):
        native.stamp_discs(b, h, w, cx, cy[:-1], r, keys)
    with pytest.raises(ValueError, match="buf must have length"):
        native.stamp_discs(b[:-1], h, w, cx, cy, r, keys)
    with pytest.raises(ValueError, match="contiguous"):
        native.stamp_discs(torch.full((2 * w * h,), -1)[::2], h, w, cx, cy, r, keys)
    with pytest.raises(ValueError, match="read-only"):
        native.stamp_discs(np.frombuffer(a.tobytes(), np.uint64), h, w, cx, cy, r, keys)
    with pytest.raises(ValueError, match="finite"):
        native.stamp_discs(b, h, w, cx, cy, np.where(r > 20, np.inf, r), keys)


def scene(n, seed, scale=1.0, masses=None):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)) * scale
    m = rng.choice(masses, n) if masses is not None else rng.uniform(1e3, 1e6, n)
    pos_mass = np.concatenate([pos, m[:, None]], axis=1).astype(np.float32)
    vel = np.concatenate([rng.standard_normal((n, 3)) * 20.0, np.zeros((n, 1))], axis=1).astype(np.float32)
    return pos_mass, vel


def test_quantized_frame_stamps_like_its_twin():
    """The quantized frame's large splats stamped in C equal the torch
    stamp's frame on the same words, on a scene with many large splats."""
    pos_mass, vel = scene(4_000, 5, scale=1.5, masses=np.geomspace(1e5, 5e9, 64))
    w, h = 200, 150
    prep = rasterize.prep_device(torch.from_numpy(pos_mass), torch.from_numpy(vel), Camera(target=np.zeros(3),
                                 radius=2.5), w, h, 1000.0, 64, "magnitude")
    words = resolve.quantized_scatter(*prep, width=w, height=h)
    large = resolve.quantized_large(*prep)
    assert large[0].shape[0] > 100
    got = resolve.quantized_frame(words, large, width=w, height=h)
    want = resolve.quantized_frame_plain(words, large, width=w, height=h)
    assert torch.equal(got, want)
    assert not torch.equal(got, words.to(torch.int64) + (1 << 31))


@pytest.mark.parametrize("color_mode", ["magnitude", "direction"])
def test_host_resolve_matches_its_twin_and_jax_numpy(color_mode):
    """``resolve_host`` (one C pass over every splat) is the twin
    ``resolve_keys_plain``'s framebuffer, and its image the JAX package's
    numpy resolve's."""
    pos_mass, vel = scene(6_000, 17, scale=1.5, masses=np.geomspace(1e3, 5e9, 32))
    args = (Camera(target=np.zeros(3), radius=3.0), 200, 150, 1000.0, 64, color_mode)
    cx, cy, keys, r = rasterize._prep_host(pos_mass, vel, *args)
    got = rasterize.resolve_host(cx, cy, keys, r, width=200, height=150)
    twin = resolve.resolve_keys_plain(*(torch.from_numpy(a) for a in (cx, cy, keys.view(np.int64), r)),
                                      width=200, height=150)
    assert torch.equal(got, twin)
    img = rasterize.render_points(pos_mass, vel, args[0], width=200, height=150, color_mode=color_mode,
                                  resolve="host")
    want = jax_raster.render_points(pos_mass, vel, JaxCamera(target=np.zeros(3), radius=3.0), width=200,
                                    height=150, color_mode=color_mode, resolve="numpy")
    np.testing.assert_array_equal(img, want)
    assert (r >= 6).sum() > 10 and (img.sum(axis=2) > 0).sum() > 1000


# ----------------------------------------------------------------- JSON
N = 600


@pytest.fixture(scope="module")
def sims():
    """A JAX and a port Simulation on one two-galaxy state after 2 steps,
    with runtime dt/G changed from the config."""
    js = JaxSimulation.from_preset("two-galaxy", JaxConfig(backend="jnp", G=3e-4), n=N, platform="cpu")
    js.run(2, chunk=2)
    js.dt, js.G = 2e-4, 5e-4
    ts = Simulation(SimConfig(backend="jnp", G=3e-4), *js.arrays(), step=js.step_count, device="cpu",
                    camera_target=js.camera_target)
    ts.dt, ts.G = 2e-4, 5e-4
    return js, ts


def nonfinite(js, ts):
    """The two Simulations on the state with a NaN, an inf and a -inf."""
    pm, vel, acc = (a.copy() for a in js.arrays())
    vel[3, 1], acc[5, 0], acc[7, 2] = np.nan, np.inf, -np.inf
    j = JaxSimulation(js.config, pm, vel, acc, step=js.step_count, camera_target=js.camera_target, platform="cpu")
    t = Simulation(ts.config, pm, vel, acc, step=ts.step_count, device="cpu", camera_target=ts.camera_target)
    for s in (j, t):
        s.dt, s.G = 2e-4, 5e-4
    return j, t


@pytest.mark.parametrize("state", ["finite", "nan and inf"])
def test_json_file_is_the_jax_packages_byte_for_byte(sims, tmp_path, state):
    js, ts = sims if state == "finite" else nonfinite(*sims)
    js.save(str(tmp_path / "j.json"))
    ts.save(str(tmp_path / "t.json"))
    got, want = (tmp_path / "t.json").read_bytes(), (tmp_path / "j.json").read_bytes()
    assert got == want
    assert (b"NaN" in got and b"Infinity" in got) == (state != "finite")
    back = Simulation.load(str(tmp_path / "t.json"), device="cpu")
    for x, y in zip(back.arrays(), ts.arrays()):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


def loads_arrays(raw: bytes) -> list[np.ndarray]:
    doc = json.loads(raw)
    return [np.asarray(doc[k], np.float32).reshape(-1, 4) for k in ("bodies", "vel", "accel")]


@pytest.mark.parametrize("writer", ["jax", "json.dump"])
def test_reading_gives_json_loads_arrays(sims, tmp_path, writer):
    """The port reads the JAX package's file and one written by plain
    ``json.dump`` (repr digits) to the float32 arrays of ``json.loads``."""
    js, ts = sims
    path = tmp_path / "c.json"
    if writer == "jax":
        js.save(str(path))
    else:
        pm, vel, acc = ts.arrays()
        doc = {"bodies": [float(v) for v in pm.reshape(-1)], "vel": [float(v) for v in vel.reshape(-1)],
               "accel": [float(v) for v in acc.reshape(-1)], "G": "-3.30", "dt": 2e-4, "step": 2, "nBodies": N}
        path.write_text(json.dumps(doc))
    got = Simulation.load(str(path), device="cpu")
    for x, y in zip(got.arrays(), loads_arrays(path.read_bytes())):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    assert got.step_count == 2 and got.dt == 2e-4 and got.G == 10.0 ** -3.3


SCAN_CASES = {
    "exponents": b"[1e5, 1E-5, -2.5e+3, 6.02214076e23, 1e-7]",
    "-0.0": b"[-0.0, 0.0, -0.0e0, 0]",
    "the least subnormal": b"[1.4e-45, 1e-45, 7.1e-46, 1.401298464324817e-45]",
    "the largest float32": b"[3.4028235e38, -3.4028235e38, 3.4028234663852886e+38]",
    "newlines between numbers": b"[\n  1.5,\n  -2.25,\r\n\t3\n]",
    "empty": b"[]",
    "repr digits": json.dumps([float(v) for v in np.float32([0.1, 1 / 3, 2 / 3, 1e-38, 123456.789])]).encode(),
}


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scanner_reads_json_loads_float32s(name):
    raw = SCAN_CASES[name]
    doc = b'{"bodies": ' + raw + b', "n": 1}'
    arr, end = native.scan_f32(doc, doc.index(b"["))
    want = np.asarray(json.loads(raw), np.float32)
    np.testing.assert_array_equal(arr.view(np.uint32), want.view(np.uint32))
    assert doc[end:] == b', "n": 1}'
    ja, je = jax_native.scan_f32(doc, doc.index(b"["))
    np.testing.assert_array_equal(arr.view(np.uint32), ja.view(np.uint32))
    assert je == end


def test_dumps_is_the_jax_codecs_on_edge_values():
    v = np.float32([0.0, -0.0, 1e-45, 3.4028235e38, -1.17549435e-38, 0.1, 1 / 3, 16777217, 1e-7])
    rng = np.random.default_rng(8)
    v = np.concatenate([v, (rng.standard_normal(5000) * 10.0 ** rng.integers(-40, 39, 5000)).astype(np.float32)])
    got = native.dumps_f32(v)
    assert got == jax_native.dumps_f32(v)
    np.testing.assert_array_equal(np.float32(json.loads(got)), v)
    # %.9g writes -0.0 as "-0", which json.loads reads as the integer 0;
    # the scanner keeps the sign: the round trip is bit for bit.
    assert got.startswith(b"[0, -0, ")
    np.testing.assert_array_equal(native.scan_f32(got, 0)[0].view(np.uint32), v.view(np.uint32))
    assert native.dumps_f32(v[:0]) == b"[]"
    with pytest.raises(ValueError, match="not finite"):
        native.dumps_f32(np.float32([1.0, np.nan]))


@pytest.mark.parametrize("bad", [b"[1, 2", b"[1, x]", b"[1, 2,, }", b"[1; 2]"])
def test_malformed_array_raises(sims, tmp_path, bad):
    """A malformed array: the scanner rejects it, and the loader's
    ``json.loads`` of the whole document raises, as the JAX package's."""
    assert native.scan_f32(bad, 0) is None
    js, _ = sims
    js.save(str(tmp_path / "c.json"))
    raw = (tmp_path / "c.json").read_bytes()
    start = raw.index(b"[", raw.index(b'"vel"'))
    (tmp_path / "bad.json").write_bytes(raw[:start] + bad + raw[raw.index(b"]", start) + 1:])
    with pytest.raises(ValueError):
        Simulation.load(str(tmp_path / "bad.json"), device="cpu")
    with pytest.raises(ValueError):
        JaxSimulation.load(str(tmp_path / "bad.json"), platform="cpu")


def test_a_document_the_scanner_rejects_is_read_by_json_loads(sims, tmp_path):
    """Where the scanner rejects a document whose arrays ``json.loads``
    reads (a string holding '"bodies" [' ahead of the key), both packages
    read it whole with ``json.loads``, to the same arrays."""
    js, _ = sims
    js.save(str(tmp_path / "c.json"))
    raw = (tmp_path / "c.json").read_bytes()
    doc = b'{"note": "x\\"bodies [a", ' + raw[1:]
    assert native.scan_f32(doc, doc.index(b"[")) is None
    (tmp_path / "odd.json").write_bytes(doc)
    got = Simulation.load(str(tmp_path / "odd.json"), device="cpu")
    want = JaxSimulation.load(str(tmp_path / "odd.json"), platform="cpu")
    for x, y, z in zip(got.arrays(), want.arrays(), loads_arrays(doc)):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
        np.testing.assert_array_equal(x.view(np.uint32), z.view(np.uint32))


# --------------------------------------------------------- a failed build
@pytest.mark.parametrize("path", ["stamp_discs", "host frame", "quantized frame", "dumps_f32", "scan_f32", "save"])
def test_a_failed_build_raises(monkeypatch, tmp_path, path, sims):
    """``CC=false`` and an empty build directory: every path that runs the
    C code raises with the compiler's failure; none falls back to a torch
    loop or to ``json.dump``."""
    _, ts = sims
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CC", "false")
    _build.load_host_library.cache_clear()
    one = np.zeros(1, np.int64)
    calls = {
        "stamp_discs": lambda: native.stamp_discs(np.full(4, ALL_ONES), 2, 2, one, one, np.ones(1), one),
        "host frame": lambda: rasterize.render_points(*scene(50, 1), Camera(target=np.zeros(3), radius=3.0),
                                                      width=32, height=24, resolve="host"),
        "quantized frame": lambda: resolve.quantized_frame(torch.zeros(4, dtype=torch.int32),
                                                           (torch.zeros(1, dtype=torch.int64),) * 3
                                                           + (np.full(1, 2.0),), width=2, height=2),
        "dumps_f32": lambda: native.dumps_f32(np.ones(3, np.float32)),
        "scan_f32": lambda: native.scan_f32(b"[1, 2]", 0),
        "save": lambda: ts.save(str(tmp_path / "c.json")),
    }
    lib = "_fastjson" if path in ("dumps_f32", "scan_f32", "save") else "_raster"
    try:
        with pytest.raises(RuntimeError, match=f"failed to build {lib}.c"):
            calls[path]()
    finally:
        _build.load_host_library.cache_clear()
    assert not (tmp_path / "c.json").exists()
