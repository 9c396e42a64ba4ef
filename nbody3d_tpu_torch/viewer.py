"""Live interactive viewer: the reference's browser app, served from the card.

The port of ``nbody3d_tpu/viewer.py``.  The reference is a real-time app: a
render loop (``nbody3d.js:439-514``), dt/G log sliders (``util.js:38-54``),
play/pause (``util.js:56-64``), an orbit/pan/zoom camera driven by mouse
and keys (``camera.js:132-251``) and a live HUD (``index.html:16-48``).
A background thread advances the simulation in chunks and encodes JPEG
frames (``render/jpeg.py``, the port's own encoder); a stdlib HTTP server
streams them as MJPEG and takes the controls.

The loop's frame is pipelined on CUDA stream order:
``render_frame_begin`` enqueues the frame's device work on the pre-chunk
state, ``run_async`` the next chunk after it; ``render_frame_finish``
waits on the frame's event alone, so the JPEG encode and publish run on
the host while the chunk runs on the card; ``wait_chunk`` ends the frame.

Endpoints (as the JAX package's):
  GET  /         control page (sliders, buttons, key bindings, HUD)
  GET  /stream   multipart/x-mixed-replace MJPEG of live frames
  GET  /frame.jpg  the latest frame
  GET  /stats    JSON HUD data (step, rates, energy, camera pose)
  GET  /control  query-string controls: dt, logdt, G, logG, pause,
                 orbit=dx,dy, pan=dx,dy, zoom=d, fov=d, dollyfov=d,
                 reset[&ctrl&alt], regenerate[&galaxies&min_bodies
                 &max_bodies], size=WxH
  GET  /export.json | /export.npz   the state as a checkpoint
  POST /import.json | /import.npz   load a checkpoint into the running sim
                 (any N: the sim is rebuilt; the saved camera is restored)

dt and G are runtime scalars of the step, so a slider move changes no
compiled code.  Held keys move the camera every frame tick with the
reference's per-frame speeds (``nbody3d.js:445-449``, ``camera.js:6-9``).

On a mesh (one process a rank) only rank 0 owns the server and the loop;
every other rank runs :func:`follow`.  Each op of rank 0's viewer that
makes a collective call (a frame, a paused frame, export, import,
regenerate) is made under ``_sim_lock`` right after rank 0 broadcasts one
small op record over a gloo side group (:func:`control_group`, so the
control traffic never sits on the NCCL stream): the op, its arguments, and
the runtime dt, G and paused dt that rank 0's simulation holds.  Every
rank then makes the op through :func:`apply_op`, the one place the
protocol is written, so every rank keeps one state.  On a mesh the dt, G
and pause controls also take ``_sim_lock``, so they change the simulation
between ops.  :meth:`LiveViewer.stop` sends the last op, ``stop``, which
ends the followers.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from nbody3d_tpu_torch.config import log_slider_dt, log_slider_G
from nbody3d_tpu_torch.render.jpeg import encode_jpeg
from nbody3d_tpu_torch.utils.camera import Camera

# The JAX package's page (nbody3d_tpu/viewer.py), its title aside.
_PAGE = """<!DOCTYPE html>
<html><head><title>nbody3d_tpu_torch live</title><style>
body { margin:0; background:#000; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; white-space:pre; font-size:12px;
       background:rgba(0,0,0,.55); padding:6px; border-radius:4px; }
#panel { position:fixed; top:8px; right:8px; background:rgba(0,0,0,.55);
         padding:8px; border-radius:4px; font-size:12px; }
#panel label { display:block; margin:4px 0; }
img { width:100vw; height:100vh; object-fit:contain; display:block; }
</style></head><body>
<img id="view" src="/stream">
<div id="hud">connecting...</div>
<div id="panel">
  <button id="collapse" style="float:right">&ndash;</button>
  <div id="panelbody">
  <label>dt = 10^<span id="dtv">-4.0</span>
    <input id="dt" type="range" min="-5" max="-3" step="0.01" value="-4"></label>
  <label>G = 10^<span id="Gv">-4.0</span>
    <input id="G" type="range" min="-6" max="0" step="0.01" value="-4"></label>
  <button id="pause">pause</button> <button id="reset">reset cam</button>
  <label>galaxies <input id="ngal" type="number" min="1" max="10" value="2" style="width:3em"></label>
  <label>bodies/galaxy <input id="minb" type="number" min="1000" max="50000" value="20000" style="width:6em">
    &ndash; <input id="maxb" type="number" min="1001" max="50000" value="20000" style="width:6em"></label>
  <button id="regen">regenerate</button>
  <a href="/export.json" download="simulation_export.json">export .json</a>
  <a href="/export.npz" download="simulation_export.npz">.npz</a>
  <label>import <input id="imp" type="file" accept=".json,.npz"></label>
  <div>drag: orbit &middot; right/shift-drag: pan &middot; middle-click: reset<br>
       wheel: zoom &middot; ctrl+wheel: FOV &middot; alt+wheel: dolly zoom<br>
       arrows orbit &middot; WASD pan &middot; f/c zoom (ctrl: FOV, alt: dolly)<br>
       space reset (ctrl: keep zoom+pose &middot; alt: keep pose)</div>
  </div>
</div>
<script>
const send = q => fetch('/control?' + q);
// settings-panel collapse (util.js:77-86)
collapse.onclick = () => {
  const hidden = panelbody.style.display === 'none';
  panelbody.style.display = hidden ? '' : 'none';
  collapse.innerHTML = hidden ? '&ndash;' : '+';
};
dt.oninput = () => { dtv.textContent = dt.value; send('logdt=' + dt.value); };
G.oninput  = () => { Gv.textContent = G.value;  send('logG=' + G.value); };
pause.onclick = () => send('pause=1');
reset.onclick = () => send('reset=1');
let galDirty = false;  // only send panel values the user actually edited
ngal.oninput = minb.oninput = maxb.oninput = () => galDirty = true;
regen.onclick = () => send('regenerate=1' + (galDirty
  ? `&galaxies=${ngal.value}&min_bodies=${minb.value}&max_bodies=${maxb.value}` : ''));
imp.onchange = async () => {
  const f = imp.files[0];
  if (!f) return;
  const ext = f.name.endsWith('.npz') ? '.npz' : '.json';
  await fetch('/import' + ext, {method: 'POST', body: await f.arrayBuffer()});
};
const mods = e => (e.ctrlKey ? '&ctrl=1' : '') + (e.altKey ? '&alt=1' : '');
let drag = null;
view.onmousedown = e => {
  if (e.button === 1) { send('reset=1' + mods(e)); e.preventDefault(); return; }
  drag = [e.clientX, e.clientY, e.button === 2 || e.shiftKey];
  e.preventDefault();
};
view.oncontextmenu = e => e.preventDefault();  // right-drag pans (camera.js:132)
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const [x0, y0, pan] = drag, dx = e.clientX - x0, dy = e.clientY - y0;
  drag = [e.clientX, e.clientY, pan];
  send((pan ? 'pan=' : 'orbit=') + dx + ',' + dy);
};
// wheel: zoom / ctrl = FOV zoom / alt = dolly zoom (camera.js:168-183);
// speeds are the reference's per-deltaY constants (camera.js:3-4)
view.onwheel = e => {
  const q = e.altKey ? 'dollyfov=' + (e.deltaY * 0.0002)
          : e.ctrlKey ? 'fov=' + (e.deltaY * 0.0002)
          : 'zoom=' + (e.deltaY * 0.0005);
  send(q); e.preventDefault();
};
// Held-key continuous camera motion (nbody3d.js:445-449): key state is
// polled every frame tick and applied with the reference's per-frame
// speed constants (camera.js:6-9) — smoothness does not depend on OS
// key autorepeat.
const held = {};
let fcMode = 'zoom';  // modifier captured at the f/c key event (camera.js:227-230)
const CAMKEYS = ['ArrowUp','ArrowDown','ArrowLeft','ArrowRight','w','a','s','d','f','c'];
window.onkeydown = e => {
  if (e.key === ' ') { send('reset=1' + mods(e)); e.preventDefault(); return; }
  const k = e.key.length === 1 ? e.key.toLowerCase() : e.key;
  if (!CAMKEYS.includes(k) || e.target.tagName === 'INPUT') return;
  if (k === 'f' || k === 'c')
    fcMode = e.altKey ? 'dollyfov' : e.ctrlKey ? 'fov' : 'zoom';
  held[k] = true; e.preventDefault();
};
// normalize case on keyup too: pressing Shift mid-hold must not leak a
// stuck lowercase entry ('f' down, Shift, 'F' up)
window.onkeyup = e => {
  held[e.key.length === 1 ? e.key.toLowerCase() : e.key] = false;
};
window.onblur = () => CAMKEYS.forEach(k => held[k] = false);
const KEY_ROT_SPEED = 3, KEY_PAN_SPEED = 5,
      KEY_ZOOM_SPEED = 0.01, KEY_FOV_SPEED = 0.005;
setInterval(() => {  // per-frame key camera (nbody3d.js:445-449)
  // signs match the r3 per-event bindings (ArrowLeft -> orbit dx<0,
  // 'a' -> pan dx<0; parity-audited against camera.js:185-251)
  const q = [];
  const odx = ((held.ArrowRight|0) - (held.ArrowLeft|0)) * KEY_ROT_SPEED;
  const ody = ((held.ArrowDown|0) - (held.ArrowUp|0)) * KEY_ROT_SPEED;
  if (odx || ody) q.push(`orbit=${odx},${ody}`);
  const pdx = ((held.d|0) - (held.a|0)) * KEY_PAN_SPEED;
  const pdy = ((held.s|0) - (held.w|0)) * KEY_PAN_SPEED;
  if (pdx || pdy) q.push(`pan=${pdx},${pdy}`);
  const z = (held.c|0) - (held.f|0);  // f = zoom in (camera.js:219-225)
  if (z) q.push(fcMode === 'zoom' ? `zoom=${z * KEY_ZOOM_SPEED}`
                                  : `${fcMode}=${z * KEY_FOV_SPEED}`);
  if (q.length) send(q.join('&'));
}, 16);
// Live resize: render resolution follows the window (util.js:91-96).
let resizeT = null;
window.onresize = () => {
  clearTimeout(resizeT);
  resizeT = setTimeout(
    () => send(`size=${window.innerWidth}x${window.innerHeight}`), 200);
};
window.onload = () => send(`size=${window.innerWidth}x${window.innerHeight}`);
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  hud.textContent =
    `bodies: ${s.n}\\nstep: ${s.step}\\nfps: ${s.fps.toFixed(1)}` +
    `\\nframe ms: ${s.frame_ms.toFixed(1)}\\nhost ms: ${s.host_ms.toFixed(2)}` +
    `\\ncompute ms: ${s.compute_ms.toFixed(3)}\\nrender ms: ${s.render_ms.toFixed(3)}` +
    `\\nsteps/s: ${s.steps_per_s.toFixed(1)}\\nG-int/s: ${s.gints_per_s.toFixed(2)}` +
    `\\nE: ${s.energy === null ? 'n/a' : s.energy.toExponential(3)}` +
    (s.a === null ? '' : `\\na(t): ${s.a.toFixed(4)}`) +
    `\\ndt: ${s.dt.toExponential(2)}  G: ${s.G.toExponential(2)}` +
    `\\n${s.camera}\\n${s.resolution}${s.paused ? '\\n[paused]' : ''}`;
}, 250);
</script></body></html>"""


# The controls that change the simulation (on a mesh, between ops).
SIM_CONTROLS = ("logdt", "dt", "logG", "G", "pause")


def control_group():
    """The gloo group that carries a served mesh's op records from rank 0
    (collective: every rank creates it, in one order).  A follower waits in
    it for as long as the server runs."""
    import torch.distributed as dist

    return dist.new_group(backend="gloo", timeout=datetime.timedelta(days=1))


def _broadcast(record, side) -> dict:
    """Rank 0's ``record`` on every rank of ``side``."""
    import torch.distributed as dist

    box = [record]
    dist.broadcast_object_list(box, src=0, group=side)
    return box[0]


def _load_bytes(old, data: bytes, suffix: str):
    """A Simulation from an uploaded checkpoint's bytes, on ``old``'s device
    (or sharded over its mesh, each rank from its own copy of the bytes)
    with ``old``'s config; the file's dt and G and ``old``'s preset."""
    from nbody3d_tpu_torch.engine import Simulation
    from nbody3d_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "import" + suffix)
        with open(path, "wb") as f:
            f.write(data)
        new = Simulation.load(path, old.config, device=old.device, mesh=old.mesh)
        saved = checkpoint.peek_config(path)  # None for .json
    if saved is not None:
        # past the cosmology guard: the saved values made the checkpoint's history
        new._set_runtime(dt=saved.dt, G=saved.G)
    new._preset = old._preset  # regenerate keeps working
    return new


def _agree(ok: bool, side) -> bool:
    """Whether every rank of ``side`` is ``ok`` (collective over ``side``)."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=side)
    return bool(flag.item())


def apply_op(sim, op: dict, side=None, publish=None):
    """Make ``op``'s calls on ``sim``: the protocol of a served mesh, written
    once.  Rank 0's viewer calls it right after it broadcasts ``op`` over
    ``side`` (or alone, on one device), with ``publish``, which takes each
    frame's image; a follower calls it on each record it takes, with no
    ``publish``.  So every rank makes the same collective calls in one
    order.  A follower takes rank 0's runtime (dt, G, paused dt) from the
    record, and makes only a frame's collective part
    (``Simulation.render_frame_collective``: no image, no host render).

    An import or a regenerate builds the new simulation on each rank with
    no collective call, then the ranks agree over ``side``: if any rank
    failed, every rank keeps ``sim`` and rank 0 raises.  Returns ``(sim,
    out)``: the simulation after the op and, on rank 0, a frame's
    ``(ran_a_chunk, energy or None)`` or an export's bytes."""
    kind = op["op"]
    lead = publish is not None
    if not lead:
        sim._dt, sim._G, sim._old_dt = op["runtime"]
    if kind in ("frame", "render"):
        cam = Camera.from_dict(op["camera"])
        frame = dict(width=op["width"], height=op["height"], resolve=op["resolve"])
        if kind == "render":
            if lead:
                publish(sim.render_frame(camera=cam, **frame))
            else:
                sim.render_frame_collective(cam, **frame)
            return sim, None
        handle = sim.render_frame_begin(cam, **frame) if lead else sim.render_frame_collective(cam, **frame)
        token = sim.run_async(op["k"])
        if lead:
            publish(sim.render_frame_finish(handle))
        sim.wait_chunk(token)
        energy = float(sim.diagnostics().total_energy) if op["diagnostics"] else None
        return sim, (token is not None, energy)
    if kind == "export":
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "export" + op["suffix"])
            sim.save(path)  # collective: every rank gathers, rank 0 writes
            if not lead:
                return sim, None
            with open(path, "rb") as f:
                return sim, f.read()
    if kind in ("import", "regenerate"):
        try:
            if kind == "import":
                new, err = _load_bytes(sim, op["data"], op["suffix"]), None
            else:
                new, err = sim.regenerate(seed=op["seed"], **op["settings"]), None
        except Exception as e:  # noqa: BLE001 - the ranks agree below; rank 0 raises
            new, err = sim, e
        if side is not None and not _agree(err is None, side) and err is None:
            new, err = sim, RuntimeError(f"{kind} failed on another rank: every rank keeps the running simulation")
        if err is not None and lead:
            raise err
        return new, None
    raise ValueError(f"unknown op {kind!r}")


def follow(sim, side):
    """A served mesh's rank other than 0: take rank 0's op records from
    ``side`` and :func:`apply_op` each on ``sim`` until ``stop``.  Returns
    the simulation it ends with (an import or a regenerate swaps it)."""
    while True:
        op = _broadcast(None, side)
        if op["op"] == "stop":
            return sim
        sim, _ = apply_op(sim, op, side)


class LiveViewer:
    """The sim loop thread, the latest frame, and the controls.  ``side``
    (a served mesh's rank 0): the group of :func:`control_group`, over which
    the followers get each collective op first."""

    def __init__(
        self,
        sim,
        *,
        width: int = 960,
        height: int = 720,
        steps_per_frame: int = 20,
        diagnostics_every: int = 0,
        quality: int = 85,
        resolve: str = "auto",
        side=None,
    ):
        self.sim = sim
        self._side = side
        self._followers = side is not None  # until the stop op
        self.width, self.height = width, height
        self.steps_per_frame = max(1, steps_per_frame)
        self.diagnostics_every = diagnostics_every
        self.quality = quality
        self.resolve = resolve  # render/rasterize.py: "auto", "host" or "device"
        self.camera = Camera(target=sim.camera_target)
        self._lock = threading.Lock()  # camera and size changes vs the render
        # Held while the loop advances the state; export, import and
        # regenerate take it, so they see a chunk boundary.
        self._sim_lock = threading.Lock()
        self._frame = b""
        self._frame_event = threading.Event()
        self._stop = threading.Event()
        self.error: BaseException | None = None  # what ended the loop, if it failed
        self.control_error: str | None = None
        self._energy: float | None = None
        self._frames_done = 0
        self.chunks_done = 0  # pipelined frames (each advanced steps_per_frame steps)
        # HUD timing split (nbody3d.js:434-442,508-514): EMA-filtered frame
        # interval, fps, host overhead and sim compute, filterStrength 10;
        # and the JPEG encode's ms and the last frame's bytes.
        self._frame_ms = 10.0
        self._fps = 0.0
        self._host_ms = 0.0
        self._compute_ms = 0.0
        self.encode_ms = 0.0
        self.jpeg_bytes = 0
        self._last_frame_t: float | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True)

    # ------------------------------------------------------------- sim loop
    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop, and on a mesh the followers (the ``stop`` op)."""
        self._stop.set()
        if self._thread.ident is not None:  # started
            self._thread.join(timeout=10)
        if self._side is not None:
            with self._sim_lock:
                if self._followers:
                    _broadcast({"op": "stop"}, self._side)
                    self._followers = False

    def _do(self, op: str, **fields):
        """Rank 0's ``op``: on a mesh its record to the followers first (the
        caller holds ``_sim_lock``), then :func:`apply_op`.  Returns the op's
        output; an import or a regenerate swaps ``self.sim``."""
        sim = self.sim
        record = {"op": op, "runtime": (sim._dt, sim._G, sim._old_dt), **fields}  # live dt, G and paused dt
        if self._side is not None:
            if not self._followers:
                raise RuntimeError("the viewer has stopped its followers: no collective call is left to make")
            _broadcast(record, self._side)
        new, out = apply_op(sim, record, self._side, publish=self._publish_jpeg)
        if new is not sim:
            self.sim = new
        return out

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                self._tick()
        except BaseException as e:
            self.error = e
            self._stop.set()
            raise

    def _tick(self) -> None:
        filt = 10.0  # the reference's filterStrength (nbody3d.js:434)
        t0 = time.perf_counter()
        if self._last_frame_t is not None:
            delta = (t0 - self._last_frame_t) * 1e3
            self._frame_ms += (delta - self._frame_ms) / filt
            self._fps += (1e3 / self._frame_ms - self._fps) / filt
        self._last_frame_t = t0
        paused = self.sim.paused
        if not paused:
            self.pipelined_frame()
            compute = (time.perf_counter() - t0) * 1e3
            self._compute_ms += (compute - self._compute_ms) / filt
        else:
            self._compute_ms = 0.0  # nbody3d.js:496-498 (the dt == 0 path)
            self._render_frame()  # render only, as nbody3d.js:474
        # Host overhead (the reference's "JS ms"): the frame's wall time less
        # the sim's compute and the render: the encode, locks, bookkeeping.
        # A pipelined frame's render is inside its compute.
        host = ((time.perf_counter() - t0) * 1e3 - (0.0 if paused else self._compute_ms)
                - (self.sim.last_render_ms or 0.0))
        self._host_ms += (max(host, 0.0) - self._host_ms) / filt
        self._frames_done += 1
        if paused:
            time.sleep(0.05)

    def _snapshot(self) -> tuple[Camera, int, int]:
        with self._lock:
            return Camera.from_dict(self.camera.to_dict()), self.width, self.height

    def pipelined_frame(self) -> None:
        """One frame of the loop: the frame's device work on the current
        state (``render_frame_begin``), the next chunk after it
        (``run_async``), then the host's half of the frame, the encode and
        the publish while the chunk runs, and last the chunk's wait."""
        with self._sim_lock:
            cam, w, h = self._snapshot()
            diagnostics = bool(self.diagnostics_every and self._frames_done % self.diagnostics_every == 0)
            ran, energy = self._do("frame", camera=cam.to_dict(), width=w, height=h, resolve=self.resolve,
                                   k=self.steps_per_frame, diagnostics=diagnostics)
            self.chunks_done += ran
            if energy is not None:
                self._energy = energy

    def _render_frame(self) -> None:
        # The camera is copied under the lock and, on one device, the frame
        # rendered outside it: a large frame must not hold up /control.  On
        # a mesh the frame is a collective op, made under _sim_lock.
        if self._side is None:
            cam, w, h = self._snapshot()
            self._do("render", camera=cam.to_dict(), width=w, height=h, resolve=self.resolve)
            return
        with self._sim_lock:
            cam, w, h = self._snapshot()
            self._do("render", camera=cam.to_dict(), width=w, height=h, resolve=self.resolve)

    def _publish_jpeg(self, img) -> None:
        t0 = time.perf_counter()
        frame = encode_jpeg(img, self.quality)
        self.encode_ms += ((time.perf_counter() - t0) * 1e3 - self.encode_ms) / 10.0
        self.jpeg_bytes = len(frame)
        self._frame = frame
        self._frame_event.set()

    # ------------------------------------------------------------- controls
    def control(self, q: dict) -> None:
        if self._side is not None and any(k in q for k in SIM_CONTROLS):
            with self._sim_lock:  # between ops, so every rank's op sees one runtime
                self._control(q)
        else:
            self._control(q)

    def _control(self, q: dict) -> None:
        sim, cam = self.sim, self.camera
        with self._lock:
            try:
                if "logdt" in q:
                    v = log_slider_dt(float(q["logdt"][0]))
                    if sim.paused:
                        sim._old_dt = v  # applied on unpause (util.js:40-44)
                    else:
                        sim.dt = v
                if "dt" in q:
                    sim.dt = float(q["dt"][0])
                if "logG" in q:
                    sim.G = log_slider_G(float(q["logG"][0]))
                if "G" in q:
                    sim.G = float(q["G"][0])
                self.control_error = None
            except ValueError as err:
                # A live dt/G change refused on a comoving run
                # (Simulation._guard_cosmo_param): on the HUD, not a 500.
                self.control_error = str(err)
            if "pause" in q:
                sim.toggle_pause()
            if "orbit" in q:
                dx, dy = (float(v) for v in q["orbit"][0].split(","))
                cam.orbit(dx, dy)
            if "pan" in q:
                dx, dy = (float(v) for v in q["pan"][0].split(","))
                cam.pan(dx, dy)
            if "zoom" in q:
                cam.zoom(float(q["zoom"][0]))
            if "fov" in q:
                cam.adj_fov(float(q["fov"][0]))
            if "dollyfov" in q:
                # dolly zoom: the FOV changes, the subject keeps its size
                # (camera.js:112-117, alt+wheel / alt+f/c)
                cam.adj_fov_without_zoom(float(q["dollyfov"][0]))
            if "reset" in q:
                # partial resets (camera.js:119-128): ctrl keeps zoom and
                # pose (FOV only), alt keeps the pose (FOV and radius)
                cam.reset(ctrl="ctrl" in q, alt="alt" in q)
            if "size" in q:
                # live resize (util.js:91-96): the next frame has the size
                try:
                    w, h = (int(v) for v in q["size"][0].split("x"))
                except ValueError:
                    pass  # a malformed size is ignored, as in the JAX package
                else:
                    self.width = max(64, min(4096, w))
                    self.height = max(64, min(4096, h))

    def export_state(self, suffix: str) -> bytes:
        """The state as a checkpoint in ``suffix``'s format (the reference's
        export button, ``util.js:160-208``), at a chunk boundary."""
        with self._sim_lock:
            return self._do("export", suffix=suffix)

    def import_state(self, data: bytes, suffix: str) -> None:
        """Load an uploaded checkpoint into the running viewer (the
        reference's import button, ``util.js:217-263``): the Simulation is
        rebuilt on the same device (or mesh: the followers get the bytes,
        no shared file system assumed) with the running config, so any N
        loads; the file's physics (state, G, dt) and camera pose are
        restored."""
        with self._sim_lock:
            self._do("import", data=data, suffix=suffix)
            new = self.sim
        if new.loaded_camera is not None:
            with self._lock:
                self.camera = new.loaded_camera

    def regenerate(self, **settings) -> None:
        """Fresh random initial conditions from the sim's preset (the
        reference's regenerate button, ``util.js:69-75``); the camera
        targets the new system as a fresh run's does (``nbody3d.js:126``).
        ``settings``: the galaxy panel (``index.html:68-75``)."""
        from nbody3d_tpu_torch.engine import draw_seed

        with self._sim_lock:
            # On a mesh rank 0 draws the seed, and the record carries it.
            seed = draw_seed() if self._side is not None else None
            self._do("regenerate", seed=seed, settings=settings)
            target = self.sim.camera_target
        with self._lock:
            self.camera = Camera(target=target)

    def stats(self) -> dict:
        """The HUD's data, with the JAX package's keys."""
        sim = self.sim
        s = sim.stats
        return {
            "n": sim.n_real,
            "step": sim.step_count,
            "steps_per_s": s.steps_per_s if math.isfinite(s.steps_per_s) else 0.0,
            "gints_per_s": s.gints_per_s if math.isfinite(s.gints_per_s) else 0.0,
            "render_ms": sim.last_render_ms or 0.0,
            # the HUD's timing split (index.html:16-34 / nbody3d.js:508-514)
            "fps": self._fps,
            "frame_ms": self._frame_ms,
            "host_ms": self._host_ms,
            "compute_ms": self._compute_ms,
            "energy": self._energy,
            "a": sim.scale_factor,  # comoving runs' scale factor, None in static space
            "dt": sim.dt if not sim.paused else (sim._old_dt or 0.0),
            "G": sim.G,
            "paused": sim.paused,
            "camera": self.camera.describe(),
            "resolution": f"{self.width}x{self.height}",
            # the last refused control (a live dt/G change on a comoving run)
            "control_error": self.control_error,
        }

    # --------------------------------------------------------------- server
    def make_server(self, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, status: int, body: bytes, ctype: str, **headers) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers.items():
                    self.send_header(k.replace("_", "-"), v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    self._route()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client left
                except Exception as e:  # noqa: BLE001 - the server keeps serving; the error is a 500
                    traceback.print_exc()
                    self._send(500, f"internal error: {e!r}".encode(), "text/plain")

            def _route(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif url.path == "/stats":
                    self._send(200, json.dumps(viewer.stats()).encode(), "application/json")
                elif url.path == "/control":
                    q = parse_qs(url.query)
                    if q.pop("regenerate", None):
                        # the galaxy panel's values ride the regenerate
                        # request (main() reads the panel, index.html:68-75)
                        settings = {
                            name: int(q.pop(key)[0])
                            for key, name in (("galaxies", "num_galaxies"), ("min_bodies", "min_bodies"),
                                              ("max_bodies", "max_bodies"))
                            if key in q
                        }
                        viewer.regenerate(**settings)  # outside control()'s lock
                    viewer.control(q)
                    self.send_response(204)
                    self.end_headers()
                elif url.path in ("/export.json", "/export.npz"):
                    suffix = ".json" if url.path.endswith(".json") else ".npz"
                    ctype = "application/json" if suffix == ".json" else "application/octet-stream"
                    self._send(200, viewer.export_state(suffix), ctype,
                               Content_Disposition=f"attachment; filename=simulation_export{suffix}")
                elif url.path == "/frame.jpg":
                    viewer._frame_event.wait(timeout=10)
                    self._send(200, viewer._frame, "image/jpeg")
                elif url.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    while not viewer._stop.is_set():
                        viewer._frame_event.wait(timeout=10)
                        viewer._frame_event.clear()
                        frame = viewer._frame
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n"
                                         + f"Content-Length: {len(frame)}\r\n\r\n".encode())
                        self.wfile.write(frame)
                        self.wfile.write(b"\r\n")
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                url = urlparse(self.path)
                if url.path not in ("/import.json", "/import.npz"):
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                    viewer.import_state(data, ".json" if url.path.endswith(".json") else ".npz")
                except (BrokenPipeError, ConnectionResetError):
                    return  # the client left
                except Exception as e:  # noqa: BLE001 - a bad upload is a 400; the viewer keeps running
                    self._send(400, f"import failed: {e!r}".encode(), "text/plain")
                    return
                self.send_response(204)
                self.end_headers()

        return ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        """Serve until interrupted; a failure of the loop stops the server
        and raises."""
        server = self.make_server(host, port)
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        serving.start()
        self.start()
        print(f"live viewer at http://{host}:{server.server_address[1]}/", flush=True)
        try:
            while not self._stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
            server.shutdown()
            server.server_close()
        if self.error is not None:
            raise RuntimeError("the viewer's loop failed") from self.error
