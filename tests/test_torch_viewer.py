"""The live viewer's slice of the port on the CPU, against the JAX package:
the quantized ``device`` resolve, the engine's pipelined frame API and
``regenerate``, and ``viewer.LiveViewer``.

- Device resolve: fed the outputs of JAX's ``_prep_device_raw``, the
  port's framebuffer is bit-equal to JAX's ``_scatter_resolve_jit`` plus
  its host stamp of the large splats; the whole frame against JAX
  ``render_points(resolve="device")``: lit pixels and colours equal on
  >= 99.9% (the bar between the two preps, ``test_torch_render.py``); the
  single-body case of ``tests/test_render.py:237``.
- Engine: ``run_async(k)`` + ``wait_chunk`` bit-equal to ``run(k)``; a
  frame begun before ``run_async`` and finished after it equals
  ``render_frame`` before the run; ``regenerate`` bit-equal to JAX's.
- Viewer: one control sequence leaves JAX's viewer and the port's with
  equal dt, G, pause state and camera pose; the same ``stats()`` keys; the
  page is JAX's but for the title; exports load across the packages; and
  the port's counterparts of ``tests/test_viewer.py``'s 13 tests, on
  ``device="cpu"``, every socket call with a timeout and every server
  stopped in the fixture's finaliser.
"""

import http.client
import io
import json
import threading
import time
from urllib.parse import parse_qs

import numpy as np
import pytest

pytest.importorskip("jax")
PIL_Image = pytest.importorskip("PIL.Image")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu import native  # noqa: E402
from nbody3d_tpu import viewer as jax_viewer  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.render import rasterize as jax_raster  # noqa: E402
from nbody3d_tpu.utils.camera import Camera as JaxCamera  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, viewer  # noqa: E402
from nbody3d_tpu_torch.render import rasterize, resolve  # noqa: E402
from nbody3d_tpu_torch.render.jpeg import encode_jpeg  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402

TIMEOUT = 20  # seconds, every socket call


def scene(n, seed, *, scale=2.5, masses=None):
    """tests/test_render.py's scenes: bodies N(0, scale), masses U(10, 50),
    the first at ``masses``, velocities N(0, 5)."""
    rng = np.random.default_rng(seed)
    pm = np.concatenate([rng.normal(scale=scale, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)
    if masses is not None:
        pm[: len(masses), 3] = masses
    return pm, rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)


# name: (scene, camera radius, frame).  Small and large splats: the heavy
# bodies reach r >= 2 px (stamped on the host) and the 64 px cap.
SCENES = {
    "512 dense, 96x80": (scene(512, 13, masses=np.geomspace(1e6, 1e9, 24)), 4.0, dict(width=96, height=80)),
    "400 radii 2-64, 96x80": (scene(400, 11, scale=2.0, masses=np.geomspace(1e5, 5e9, 32)), 2.0,
                              dict(width=96, height=80)),
    "300 close, 80x64 sf 80": (scene(300, 3, scale=1.0), 5.0, dict(width=80, height=64, size_factor=80.2)),
    "256 direction colours, 64x48": (scene(256, 5, masses=np.geomspace(1e7, 3e9, 24)), 3.0,
                                     dict(width=64, height=48, color_mode="direction")),
}


def _jax_device_buffer(pm, vel, cam, frame):
    """JAX's device resolve up to its framebuffer: ``_scatter_resolve_jit``
    on the sorted prep, then the host stamp of the large-splat prefix
    (``_render_device_resolve``'s steps), and the prep's arrays."""
    w, h = frame["width"], frame["height"]
    out = jax_raster._prep_device_raw(pm, vel, cam, w, h, frame.get("size_factor", 1000.0), 64,
                                      frame.get("color_mode", "magnitude"))
    cx, cy, depth, rgb, r, nvis = (np.asarray(a) for a in out)
    buf_d, n_large = jax_raster._scatter_resolve_jit()(*out, width=w, height=h)
    k = int(n_large)
    buf = np.asarray(buf_d).astype(np.uint64)
    keys = ((depth[:k].astype(np.uint64) >> 16) << 16) | jax_raster._rgb565_host(rgb[:k])
    native.raster.stamp_discs(buf, h, w, np.ascontiguousarray(cx[:k].astype(np.int64)),
                              np.ascontiguousarray(cy[:k].astype(np.int64)),
                              np.ascontiguousarray(r[:k].astype(np.float64)), np.ascontiguousarray(keys))
    return buf, (cx, cy, depth, rgb, r, int(nvis)), k


@pytest.mark.parametrize("name", list(SCENES))
def test_device_resolve_bit_equal_on_jax_prep(name):
    (pm, vel), rad, frame = SCENES[name]
    want, (cx, cy, depth, rgb, r, nvis), k = _jax_device_buffer(pm, vel, JaxCamera(target=np.zeros(3), radius=rad),
                                                                frame)
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).view(dt).copy())  # noqa: E731
    got = resolve.resolve_quantized(as_t(cx, np.int32), as_t(cy, np.int32), as_t(depth, np.int32),
                                    as_t(rgb, np.int32), as_t(r, np.float32), torch.arange(len(cx)) < nvis,
                                    width=frame["width"], height=frame["height"])
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    assert (want != resolve.EMPTY32).any()
    if name != "300 close, 80x64 sf 80":
        assert k > 0  # the host stamp ran


@pytest.mark.parametrize("name", list(SCENES))
def test_device_resolve_frame_against_jax(name):
    (pm, vel), rad, frame = SCENES[name]
    want = jax_raster.render_points(pm, vel, JaxCamera(target=np.zeros(3), radius=rad), resolve="device", **frame)
    got = rasterize.render_points(torch.from_numpy(pm), torch.from_numpy(vel), Camera(target=np.zeros(3), radius=rad),
                                  resolve="device", **frame)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got.any(axis=2) == want.any(axis=2)).mean() >= 0.999
    assert (got == want).all(axis=2).mean() >= 0.999


def test_device_resolve_two_galaxy_as_jax():
    """The JAX test's bar against the exact frame (rgb within 8 on > 0.995
    of the pixels both light) is a property of its random scene: on the
    two-galaxy preset both packages' device resolves fall below it alike
    (16-bit depth ties in a galaxy's narrow depth range), with equal
    shares, and light the same pixels as their exact frames."""
    from nbody3d_tpu.models.registry import make_preset

    pm, vel, target = make_preset("two-galaxy", seed=0, G=1e-4, size_factor=1000.0, n=512)
    kw = dict(width=96, height=80)

    def shares(exact, quantized):
        lit, lit_q = exact.any(axis=2), quantized.any(axis=2)
        both = lit & lit_q
        return (lit == lit_q).mean(), (np.abs(exact[both].astype(int) - quantized[both].astype(int)) <= 8).all(1).mean()

    jc, tc = JaxCamera(target=target), Camera(target=target)
    want = shares(jax_raster.render_points(pm, vel, jc, prep="device", **kw),
                  jax_raster.render_points(pm, vel, jc, resolve="device", **kw))
    p, v = torch.from_numpy(pm), torch.from_numpy(vel)
    got = shares(rasterize.render_points(p, v, tc, **kw), rasterize.render_points(p, v, tc, resolve="device", **kw))
    assert got == want and got[0] > 0.999 and got[1] < 0.995


def test_device_resolve_single_body():
    """tests/test_render.py:237: one small body lands on the centre pixel
    with its colour within rgb565's band."""
    cam = Camera(target=np.zeros(3), radius=5.0)
    pm, vel = np.array([[0, 0, 0, 100.0]], np.float32), np.zeros((1, 4), np.float32)
    kw = dict(width=96, height=80, size_factor=1000.0)
    a = rasterize.render_points(pm, vel, cam, **kw)
    b = rasterize.render_points(pm, vel, cam, resolve="device", **kw)
    want = jax_raster.render_points(pm, vel, JaxCamera(target=np.zeros(3), radius=5.0), resolve="device", **kw)
    assert a[40, 48].any() and b[40, 48].any()
    assert np.abs(a[40, 48].astype(int) - b[40, 48].astype(int)).max() <= 8
    np.testing.assert_array_equal(b, want)


def test_device_resolve_buffer_and_empty_frames():
    (pm, vel), rad, frame = SCENES["512 dense, 96x80"]
    cam = Camera(target=np.zeros(3), radius=rad)
    buf = rasterize.render_buffer(pm, vel, cam, resolve="device", **frame)
    assert buf.device.type == "cpu" and buf.dtype == torch.int64 and buf.shape == (96 * 80,)
    assert int(buf.max()) == resolve.EMPTY32 and int(buf.min()) < 0x3F810000
    torch.testing.assert_close(buf, rasterize.render_buffer(pm, vel, cam, resolve="device", **frame), rtol=0, atol=0)
    behind = np.array([[0, 0, 100.0, 1e6]], np.float32)
    assert not rasterize.render_points(behind, np.zeros((1, 4), np.float32), cam, width=32, height=32,
                                       resolve="device").any()
    prep = rasterize.prep_device(torch.from_numpy(pm), torch.from_numpy(vel), cam, 96, 80)
    empty = resolve.resolve_quantized(*(t[:0] for t in prep), width=96, height=80)
    assert (empty == resolve.EMPTY32).all()


# ------------------------------------------------------------------ engine
ENGINE_CONFIGS = {
    "exact": dict(block_target=32),
    "sym": dict(force_mode="sym", block_target=32),
    "plain": dict(backend="jnp"),
}


@pytest.mark.parametrize("name", list(ENGINE_CONFIGS))
def test_run_async_equals_run(name):
    cfg = SimConfig(**ENGINE_CONFIGS[name])
    a = Simulation.from_preset("two-galaxy", cfg, n=300, device="cpu")
    b = Simulation.from_preset("two-galaxy", cfg, n=300, device="cpu")
    a.run(5, chunk=5)
    token = b.run_async(5)
    b.wait_chunk(token)
    for x, y in zip(a.arrays(), b.arrays()):
        np.testing.assert_array_equal(x, y)
    assert b.step_count == 5 and b.stats.total_steps == 5 and b.stats.ms_per_step > 0
    b.toggle_pause()
    assert b.run_async(5) is None  # paused: nothing runs
    b.wait_chunk(None)
    assert b.step_count == 5


@pytest.mark.parametrize("resolve_name", ["auto", "host", "device"])
def test_frame_begun_before_the_chunk_renders_the_pre_chunk_state(resolve_name, tmp_path):
    sim = Simulation.from_preset("two-galaxy", SimConfig(block_target=32), n=400, device="cpu")
    sim.metrics_path = str(tmp_path / "m.jsonl")
    cam = Camera(target=sim.camera_target, radius=3.0)
    want = sim.render_frame(cam, width=96, height=80, resolve=resolve_name)
    handle = sim.render_frame_begin(cam, width=96, height=80, resolve=resolve_name)
    token = sim.run_async(4)
    got = sim.render_frame_finish(handle)
    sim.wait_chunk(token)
    np.testing.assert_array_equal(got, want)
    assert want.any() and sim.step_count == 4
    assert sim.last_render_ms > 0 and sim.last_render_info.startswith("96x80 ")
    after = sim.render_frame(cam, width=96, height=80, resolve=resolve_name)
    assert not np.array_equal(after, want)  # the chunk moved the bodies
    rec = json.loads(open(sim.metrics_path).read().splitlines()[-1])
    assert rec["chunk"] == 4 and rec["render_ms"] > 0
    with pytest.raises(ValueError, match="unknown resolve"):
        sim.render_frame_begin(cam, resolve="pallas")


@pytest.mark.parametrize("settings", [{}, dict(num_galaxies=3, min_bodies=30, max_bodies=40)])
@pytest.mark.parametrize("preset", ["uniform-sphere", "two-galaxy"])
def test_regenerate_equals_jax(preset, settings):
    js = JaxSimulation.from_preset(preset, JaxConfig(backend="jnp"), n=64, platform="cpu")
    ts = Simulation.from_preset(preset, SimConfig(backend="jnp"), n=64, device="cpu")
    for s in (js, ts):
        s.G = 3e-4
        s.dt = 2e-4
        s.toggle_pause()  # the live dt is the one saved while paused
    jr, tr = js.regenerate(seed=5, **settings), ts.regenerate(seed=5, **settings)
    for x, y in zip(jr.arrays(), tr.arrays()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jr.camera_target, tr.camera_target)
    assert (jr.dt, jr.G, jr.n_real, jr.config.seed) == (tr.dt, tr.G, tr.n_real, tr.config.seed) == \
        (2e-4, 3e-4, jr.n_real, 5)
    assert jr._preset == tr._preset and tr.device.type == "cpu"
    again = tr.regenerate(seed=6)  # the panel's settings persist
    assert again._preset == tr._preset and (settings or again.n_real == tr.n_real)
    with pytest.raises(ValueError, match="preset-built"):
        Simulation(SimConfig(), *tr.arrays()[:2], device="cpu").regenerate()


# ------------------------------------------------------------------ viewer
CONTROLS = ["logdt=-3.5", "logG=-2", "pause=1", "logdt=-4.2", "orbit=10,-3", "pan=5,7", "zoom=0.5", "fov=0.1",
            "dollyfov=0.15", "reset=1&ctrl=1", "zoom=-0.2&orbit=3,4", "reset=1&alt=1", "pause=1", "dt=2e-4",
            "G=3e-4", "size=96x80", "size=bogus", "orbit=-20,15&pan=-4,2", "reset=1"]


def test_controls_match_jax_viewer():
    jv = jax_viewer.LiveViewer(JaxSimulation.from_preset("uniform-sphere", JaxConfig(backend="jnp"), n=64,
                                                         platform="cpu"), width=64, height=48)
    tv = viewer.LiveViewer(Simulation.from_preset("uniform-sphere", SimConfig(backend="jnp"), n=64, device="cpu"),
                           width=64, height=48)
    for q in CONTROLS:
        jv.control(parse_qs(q))
        tv.control(parse_qs(q))
        for attr in ("dt", "G", "paused", "_old_dt"):
            assert getattr(tv.sim, attr) == getattr(jv.sim, attr), (q, attr)
        assert (tv.width, tv.height) == (jv.width, jv.height)
        want, got = jv.camera.to_dict(), tv.camera.to_dict()
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float), rtol=1e-12, err_msg=q)
    assert tv.stats().keys() == jv.stats().keys()
    s = json.loads(json.dumps(tv.stats()))
    assert s["resolution"] == "96x80" and s["paused"] is False and s["a"] is None


def test_page_is_jax_page_but_the_title():
    assert viewer._PAGE.replace("nbody3d_tpu_torch live", "nbody3d_tpu live") == jax_viewer._PAGE
    assert viewer._PAGE != jax_viewer._PAGE


def test_exports_load_across_packages():
    jv = jax_viewer.LiveViewer(JaxSimulation.from_preset("two-galaxy", JaxConfig(backend="jnp", G=2e-4), n=200,
                                                         platform="cpu"))
    tv = viewer.LiveViewer(Simulation.from_preset("uniform-sphere", SimConfig(backend="jnp"), n=64, device="cpu"))
    jv.sim.run(2, chunk=2)
    tv.import_state(jv.export_state(".npz"), ".npz")  # JAX -> port
    for x, y in zip(jv.sim.arrays(), tv.sim.arrays()):
        np.testing.assert_array_equal(x, y)
    assert (tv.sim.G, tv.sim.dt, tv.sim.step_count) == (jv.sim.G, jv.sim.dt, jv.sim.step_count)
    np.testing.assert_allclose(tv.camera.target, jv.sim.camera_target)
    tv.sim.run(1, chunk=1)
    jv.import_state(tv.export_state(".json"), ".json")  # port -> JAX
    for x, y in zip(tv.sim.arrays(), jv.sim.arrays()):
        np.testing.assert_array_equal(x, y)
    assert jv.sim.step_count == tv.sim.step_count == 3


# ------------------------------------ the counterparts of tests/test_viewer.py
@pytest.fixture()
def live():
    sim = Simulation.from_preset("uniform-sphere", SimConfig(backend="jnp"), n=64, device="cpu")
    v = viewer.LiveViewer(sim, width=64, height=48, steps_per_frame=2)
    server = v.make_server("127.0.0.1", 0)  # an ephemeral port
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    v.start()
    yield v, server.server_address[1]
    v.stop()
    server.shutdown()
    server.server_close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and not v._thread.is_alive()
    assert v.error is None


def _get(port, path, retries=5):
    """GET with a timeout, and a few retries where a loaded machine drops
    the connection in its handshake."""
    last = None
    for _ in range(retries):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read() if resp.getheader("Content-Length") else b""
            status, headers = resp.status, dict(resp.getheaders())
            conn.close()
            return status, headers, body
        except (http.client.RemoteDisconnected, ConnectionError) as e:
            last = e
            time.sleep(0.2)
    raise last


def _post(port, path, data, retries=5):
    last = None
    for _ in range(retries):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
            conn.request("POST", path, body=data)
            resp = conn.getresponse()
            body, status = resp.read(), resp.status
            conn.close()
            return status, body
        except (http.client.RemoteDisconnected, ConnectionError) as e:
            last = e
            time.sleep(0.2)
    raise last


def _wait(pred, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def test_page_and_stats(live):
    v, port = live
    status, headers, body = _get(port, "/")
    assert status == 200 and b"nbody3d_tpu_torch live" in body
    assert b'min="-5" max="-3"' in body  # dt slider (util.js:38-54)
    assert b'min="-6" max="0"' in body  # G slider
    assert _wait(lambda: json.loads(_get(port, "/stats")[2])["step"] > 0)
    s = json.loads(_get(port, "/stats")[2])
    assert s["n"] == 64 and "cam target=" in s["camera"] and s["resolution"] == "64x48"
    assert s["a"] is None  # static space


def test_frame_endpoint_serves_jpeg(live):
    v, port = live
    status, headers, body = _get(port, "/frame.jpg")
    assert status == 200 and headers["Content-Type"] == "image/jpeg"
    assert body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9"
    assert PIL_Image.open(io.BytesIO(body)).size == (64, 48)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    assert resp.status == 200 and "multipart/x-mixed-replace" in resp.getheader("Content-Type")
    for _ in range(3):  # three parts of the MJPEG stream
        assert resp.readline() == b"--frame\r\n"
        assert resp.readline() == b"Content-Type: image/jpeg\r\n"
        n = int(resp.readline().split(b":")[1])
        assert resp.readline() == b"\r\n"
        part = resp.read(n)
        assert part[:2] == b"\xff\xd8" and part[-2:] == b"\xff\xd9"
        assert resp.readline() == b"\r\n"
    conn.close()
    assert _get(port, "/nothing")[0] == 404


def test_controls_change_live_params(live):
    v, port = live
    _get(port, "/control?logdt=-3.5")
    assert np.isclose(v.sim.dt, 10**-3.5)
    _get(port, "/control?logG=-2")
    assert np.isclose(v.sim.G, 1e-2)
    _get(port, "/control?pause=1")
    assert v.sim.paused
    # the chunk in flight when the pause landed may finish; then no steps
    frames0 = v._frames_done
    assert _wait(lambda: v._frames_done >= frames0 + 2)
    step0, frames1 = v.sim.step_count, v._frames_done
    assert _wait(lambda: v._frames_done >= frames1 + 2)
    assert v.sim.step_count == step0
    # while paused the frame is the paused state's, encoded as published
    with v._lock:
        cam = Camera.from_dict(v.camera.to_dict())
    frame = _get(port, "/frame.jpg")[2]
    assert frame == encode_jpeg(v.sim.render_frame(camera=cam, width=64, height=48), v.quality)
    _get(port, "/control?pause=1")
    assert not v.sim.paused and np.isclose(v.sim.dt, 10**-3.5)
    az0 = v.camera.azimuth
    _get(port, "/control?orbit=10,0")
    assert v.camera.azimuth != az0
    r0 = v.camera.radius
    _get(port, "/control?zoom=0.5")
    assert v.camera.radius > r0
    _get(port, "/control?reset=1")
    assert np.isclose(v.camera.radius, 5.0)


def test_modifier_camera_controls(live):
    import math

    v, port = live
    _get(port, "/control?reset=1")
    fov0, r0 = v.camera.fov, v.camera.radius
    _get(port, "/control?fov=0.1")
    assert v.camera.fov > fov0 and np.isclose(v.camera.radius, r0)
    size0 = math.tan(v.camera.fov / 2) * v.camera.radius
    _get(port, "/control?dollyfov=0.15")
    assert v.camera.fov > fov0 + 0.1
    assert np.isclose(math.tan(v.camera.fov / 2) * v.camera.radius, size0)
    _get(port, "/control?zoom=0.5&orbit=20,0")
    r1, az1 = v.camera.radius, v.camera.azimuth
    _get(port, "/control?reset=1&ctrl=1")
    assert np.isclose(v.camera.fov, fov0)
    assert np.isclose(v.camera.radius, r1) and np.isclose(v.camera.azimuth, az1)
    _get(port, "/control?fov=0.2&zoom=0.5")
    _get(port, "/control?reset=1&alt=1")
    assert np.isclose(v.camera.fov, fov0) and np.isclose(v.camera.radius, 5.0)
    assert np.isclose(v.camera.azimuth, az1)
    _get(port, "/control?reset=1")
    assert np.isclose(v.camera.azimuth, 0.0)


def test_page_galaxy_panel_matches_reference_bounds(live):
    _, port = live
    page = _get(port, "/")[2].decode()
    assert 'id="minb" type="number" min="1000" max="50000"' in page
    assert 'id="maxb" type="number" min="1001" max="50000"' in page
    assert 'id="ngal" type="number" min="1" max="10"' in page
    for frag in ("dollyfov=", "ctrl=1", "alt=1", "oncontextmenu"):
        assert frag in page, frag


def test_export_endpoints(live, tmp_path):
    v, port = live
    status, headers, body = _get(port, "/export.json")
    assert status == 200 and headers["Content-Disposition"].endswith("simulation_export.json")
    data = json.loads(body)
    for key in ("bodies", "vel", "accel", "camera", "G"):
        assert key in data
    assert len(data["bodies"]) == 64 * 4
    status, headers, body = _get(port, "/export.npz")
    assert status == 200 and body[:4] == b"PK\x03\x04"
    (tmp_path / "x.npz").write_bytes(body)
    assert Simulation.load(str(tmp_path / "x.npz"), device="cpu").n_real == 64


def test_step_count_served_mid_chunk():
    """/stats reads the step count from the HTTP thread while a chunk is in
    flight: the port's count is a host integer, advanced when the chunk is
    enqueued, so the read neither waits nor raises."""
    sim = Simulation.from_preset("uniform-sphere", SimConfig(backend="jnp"), n=64, device="cpu")
    sim.run(2, chunk=2)
    assert sim.step_count == 2
    token = sim.run_async(3)
    assert sim.step_count == 5
    sim.wait_chunk(token)
    assert sim.step_count == 5 and sim.stats.total_steps == 5


def test_live_import_and_regenerate(live):
    v, port = live
    data = json.loads(_get(port, "/export.json")[2])
    data["G"] = "-2.00"  # the slider string (util.js:200)
    data["camera"]["radius"] = 9.0
    status, pbody = _post(port, "/import.json", json.dumps(data).encode())
    assert status == 204, pbody
    assert np.isclose(v.sim.G, 1e-2) and np.isclose(v.camera.radius, 9.0) and v.sim.n_real == 64
    n4 = len(data["bodies"]) // 4
    for key in ("bodies", "vel", "accel"):
        data[key] = data[key][: (n4 // 2) * 4]
    data["nBodies"] = n4 // 2
    status, pbody = _post(port, "/import.json", json.dumps(data).encode())
    assert status == 204, pbody
    assert v.sim.n_real == 32
    assert _post(port, "/import.json", b"{not json")[0] == 400  # a bad upload; the server stays up
    assert v.sim.n_real == 32
    with v._sim_lock:
        p0 = v.sim.arrays()[0].copy()
    assert _get(port, "/control?regenerate=1")[0] == 204
    assert v.sim.n_real == 64
    with v._sim_lock:
        p1 = v.sim.arrays()[0].copy()
    assert p1.shape != p0.shape or not np.allclose(p1, p0)


def test_regenerate_with_galaxy_settings(live):
    v, port = live
    assert _get(port, "/control?regenerate=1&galaxies=3&min_bodies=30&max_bodies=30")[0] == 204
    assert v.sim.n_real == 3 * 31  # 3 galaxies x (30 disk + 1 centre)
    assert v.sim._preset[0] == "reference-random"
    _get(port, "/control?regenerate=1")
    assert v.sim.n_real == 3 * 31


def test_held_key_constants_in_page(live):
    _, port = live
    body = _get(port, "/")[2]
    for frag in (b"KEY_ROT_SPEED = 3", b"KEY_PAN_SPEED = 5", b"KEY_ZOOM_SPEED = 0.01", b"KEY_FOV_SPEED = 0.005",
                 b"window.onkeyup", b"window.onresize", b"(held.ArrowRight|0) - (held.ArrowLeft|0)",
                 b"(held.ArrowDown|0) - (held.ArrowUp|0)", b"(held.d|0) - (held.a|0)", b"(held.s|0) - (held.w|0)",
                 b"(held.c|0) - (held.f|0)", b"e.key.toLowerCase()"):
        assert frag in body, frag


def test_hud_timing_split(live):
    v, port = live
    assert _wait(lambda: (lambda s: s["step"] > 4 and s["fps"] > 0)(json.loads(_get(port, "/stats")[2])))
    s = json.loads(_get(port, "/stats")[2])
    assert s["fps"] > 0 and s["frame_ms"] > 0 and s["compute_ms"] > 0
    assert s["host_ms"] >= 0 and s["render_ms"] > 0
    assert v.encode_ms > 0 and v.jpeg_bytes > 0


def test_live_resize(live):
    v, port = live
    assert _get(port, "/control?size=96x80")[0] == 204
    assert _wait(lambda: json.loads(_get(port, "/stats")[2])["resolution"] == "96x80")
    assert _wait(lambda: PIL_Image.open(io.BytesIO(_get(port, "/frame.jpg")[2])).size == (96, 80))
    assert _get(port, "/control?size=bogus")[0] == 204  # ignored, not a 500


def test_serve_loop_pipelined_progress(live):
    """Both products keep flowing: steps advance by steps_per_frame a
    pipelined frame, and fresh frames publish."""
    v, port = live
    seen = []
    deadline = time.time() + 60
    while time.time() < deadline and len(seen) < 3:
        _get(port, "/frame.jpg")
        with v._sim_lock:
            step, chunks = v.sim.step_count, v.chunks_done
        if not seen or step > seen[-1][0]:
            seen.append((step, chunks, v._frames_done))
        time.sleep(0.1)
    assert len(seen) >= 3, seen
    assert all(s == 2 * c for s, c, _ in seen)  # 2 steps a pipelined frame
    assert seen[-1][0] > seen[0][0] and seen[-1][2] > seen[0][2]
    s = json.loads(_get(port, "/stats")[2])
    assert s["steps_per_s"] >= 0 and s["fps"] >= 0 and s["compute_ms"] >= 0 and s["render_ms"] >= 0
