"""Simulation engine: owns the state on one device, steps it in chunks.

With a ``mesh`` (``parallel/mesh.py``) the state is sharded: every rank
builds the same global state, padded to whole tiles a shard, keeps its
rows (``parallel.shard_state``) and steps them with the sharded step of
``config.strategy`` (the mesh methods' own schedules for ``pm`` and
``p3m``, comoving ones too: ``scale_factor`` is the host mirror); diagnostics
are the sharded ones, and what needs the global state (``arrays``, the
Morton re-sort, ``save``) gathers it on every rank, which makes those
calls collective: every rank makes them, in one order.  Only rank 0
writes a checkpoint.  A frame of a sharded state is collective too and the
same on every rank: ``resolve="auto"`` renders where the rows live
(``render/sharded.py``: each rank's ``splat_resolve``, one ``amin`` of the
frames), ``"host"`` and ``"device"`` gather the rows and render them as one
device does.

The host sees the state at chunk boundaries only (logging, diagnostics,
Morton re-sorts, checkpoints, frames).  Each chunk is timed on the host
clock and ends in ``torch.cuda.synchronize`` on a CUDA device, so the time
covers the device's work and not just its enqueueing.  Frames render on
the state's device (``render/``: the ``splat_resolve`` kernel on a card);
only the finished image comes to the host.

The live viewer's pipelined frame (``viewer.py``) rests on CUDA stream
order: :meth:`Simulation.render_frame_begin` enqueues a frame's device
work on the current stream and :meth:`Simulation.run_async` the next
chunk after it, so the frame reads the pre-chunk state; the host then
waits on the frame's event alone (:meth:`Simulation.render_frame_finish`)
and encodes while the chunk runs, and :meth:`Simulation.wait_chunk` waits
on the chunk's event.
"""

from __future__ import annotations

import json
import time
from typing import Iterator

import numpy as np
import torch

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.models.registry import make_preset
from nbody3d_tpu_torch.ops import diagnostics as diag_mod
from nbody3d_tpu_torch.ops.integrate import FORCE_EVALS
from nbody3d_tpu_torch.ops.morton import morton_reorder
from nbody3d_tpu_torch.ops.step import (
    fit_block,
    make_step_fn,
    pad_multiple,
    resolve_device,
    run_chunk,
)
from nbody3d_tpu_torch.parallel import sharded
from nbody3d_tpu_torch.state import SimState, init_state, pad_count, unpad
from nbody3d_tpu_torch.utils.profiling import Ema, StepStats, span


def draw_seed() -> int:
    """A fresh seed from the OS's entropy (the regenerate button's)."""
    return int(np.random.SeedSequence().generate_state(1)[0]) & 0x7FFFFFFF


def _resolve_sim_device(device, mesh) -> torch.device:
    """``device``, or the mesh's: with a mesh the state lives on its rank's
    device, and a ``device`` given beside it must be that one."""
    if mesh is None:
        if device is None:
            raise TypeError("Simulation needs a device (or a mesh)")
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device!r} is not the mesh rank's device {mesh.device}")
    return mesh.device


class Simulation:
    """A :class:`SimState` on ``device``, its step function and run
    bookkeeping.  ``device`` is required, or with a ``mesh`` its rank's
    device: ``"cuda"`` raises where there is no card, and nothing moves to
    another device behind the caller."""

    def __init__(
        self,
        config: SimConfig,
        pos_mass: np.ndarray,
        vel: np.ndarray,
        accel: np.ndarray | None = None,
        *,
        device: torch.device | str | None = None,
        step: int = 0,
        camera_target: np.ndarray | None = None,
        mesh=None,
    ):
        self.config = config
        self.mesh = mesh
        self.device = _resolve_sim_device(device, mesh)
        # The camera's orbit centre (a preset's third return value), and the
        # full camera pose of a loaded checkpoint (util.js:247-258).
        self.camera_target = (
            np.zeros(3) if camera_target is None else np.asarray(camera_target, dtype=np.float64)
        )
        self.loaded_camera = None
        # (name, n, preset_kw) when built by from_preset: what regenerate()
        # rolls again (the reference's regenerate button re-runs main()).
        self._preset: tuple | None = None
        self.n_real = int(np.asarray(pos_mass).shape[0])
        # A mesh's shards hold whole tiles: the granule times the ranks.
        self.n_pad = pad_count(self.n_real, pad_multiple(config, self.device) * (mesh.size if mesh else 1))
        # Total mass, cached on the host for the comoving background's
        # rho_bar (scale_factor): one column sum at init, not one a query.
        # Invariant: every integrator passes the mass column through
        # untouched (ops/integrate.py, ops/expansion.py) and no code path
        # changes masses in place, so this mirror stays tied to the step's
        # background, which takes rho_bar from the live state each step.
        # A feature that changes masses must refresh (or remove) this cache,
        # or scale_factor silently diverges.
        self._mass_total = float(np.asarray(pos_mass)[:, 3].sum())
        self.state = init_state(
            pos_mass, vel, accel, n_pad=self.n_pad, step=step, device=self.device
        )
        if mesh is None:
            self._step_fn = make_step_fn(config, self.n_pad, self.n_real, self.device)
        else:
            self._step_fn = sharded.make_sharded_step(config, self.n_pad, self.n_real, mesh)
            self._sharded_diag = sharded.make_sharded_diagnostics(config, self.n_pad, mesh)
            self.state = sharded.shard_state(self.state, mesh)
        # Live sliders and pause (dt swapped to 0 through _old_dt).  Direct
        # slot writes: the dt/G setters guard a comoving run's history,
        # which construction has not begun.
        self._dt = float(config.dt)
        self._G = float(config.G)
        self._old_dt: float | None = None
        self._next_morton = 0
        self.stats = StepStats(ema=Ema(10.0))
        # Optional metrics sink: one JSON line per chunk.
        self.metrics_path: str | None = None
        # The last frame's render time (host clock, ms) and size + camera.
        self.last_render_ms: float | None = None
        self.last_render_info: str | None = None
        # Pinned host buffers of the pipelined frames, by (shape, dtype),
        # and the stream that fetches a quantized frame's large splats.
        self._pinned: dict[tuple, torch.Tensor] = {}
        self._side_stream = None
        # A mesh's sharded renders, by (width, height, colour mode).
        self._sharded_renders: dict[tuple, object] = {}

    @classmethod
    def from_preset(
        cls,
        name: str,
        config: SimConfig | None = None,
        *,
        device: torch.device | str | None = None,
        n: int | None = None,
        mesh=None,
        **preset_kw,
    ) -> "Simulation":
        config = config or SimConfig()
        pos_mass, vel, target = make_preset(
            name, seed=config.seed, G=config.G, n=n,
            size_factor=config.size_factor, **preset_kw,
        )
        sim = cls(config, pos_mass, vel, device=device, camera_target=target, mesh=mesh)
        sim._preset = (name, n, dict(preset_kw))
        return sim

    def regenerate(self, seed: int | None = None, **settings) -> "Simulation":
        """A fresh Simulation from the same preset with new randomness (the
        reference's regenerate button, ``util.js:69-75``), on the same
        device; the caller swaps it in.  ``settings`` are the galaxy panel's
        (``index.html:68-75``: ``num_galaxies``, ``min_bodies``,
        ``max_bodies``): with any of them the run becomes a
        ``reference-random`` one, as the reference's ``main()`` reads the
        panel.  The live G and dt (the one saved while paused) carry over,
        as ``main()`` reads the sliders (``nbody3d.js:115``)."""
        if self._preset is None:
            raise ValueError("regenerate requires a preset-built simulation (Simulation.from_preset)")
        name, n, kw = self._preset
        if settings:
            base = kw if name == "reference-random" else {}
            name, n, kw = "reference-random", None, {**base, **settings}
        if seed is None:
            seed = draw_seed()
            if self.mesh is not None:
                # Rank 0's draw on every rank, or each would build its own state.
                seed = sharded.broadcast_int(seed, self.mesh)
        dt_live = self._old_dt if self._old_dt is not None else self.dt
        config = self.config.replace(seed=seed, G=self.G, dt=dt_live)
        return Simulation.from_preset(name, config, n=n, device=self.device, mesh=self.mesh, **kw)

    # -------------------------------------------------- live dt/G (sliders)
    @property
    def dt(self) -> float:
        return self._dt

    @dt.setter
    def dt(self, v: float) -> None:
        self._guard_cosmo_param("dt", float(v))
        self._dt = float(v)

    @property
    def G(self) -> float:
        return self._G

    @G.setter
    def G(self, v: float) -> None:
        self._guard_cosmo_param("G", float(v))
        self._G = float(v)

    def _guard_cosmo_param(self, name: str, v: float) -> None:
        """Refuse a live dt or G change on a comoving run with history: the
        background (the step's, ops/expansion.py, and the host mirror in
        :attr:`scale_factor`) takes cosmic time as ``t_i + step·dt`` from
        the current dt and G, so a change mid-run would rescale the whole
        expansion history.  Pause (dt = 0) and its undo stay allowed; a
        checkpoint restore goes through :meth:`_set_runtime`."""
        if self.config.cosmology == "none":
            return
        cur = self._dt if name == "dt" else self._G
        if v == cur or (name == "dt" and v == 0.0):
            return  # no change, or pause
        if name == "dt" and self._old_dt is not None and v == self._old_dt:
            return  # unpause
        if self.step_count == 0 and self.stats.total_steps == 0:
            return  # no history yet: the run starts from here
        raise ValueError(
            f"cannot change {name} mid-run with cosmology="
            f"{self.config.cosmology!r}: the comoving background integrates "
            f"from t_i with constant dt/G, so a live change would rescale "
            f"the entire expansion history (ops/expansion.py).  Pause, or "
            f"regenerate/restart with the new value."
        )

    def _set_runtime(self, dt: float | None = None, G: float | None = None) -> None:
        """Install dt and G past the cosmology guard: for a checkpoint
        restore, whose saved values made the history it holds."""
        if dt is not None:
            self._dt = float(dt)
        if G is not None:
            self._G = float(G)

    @property
    def paused(self) -> bool:
        return self._old_dt is not None

    def toggle_pause(self) -> None:
        """Pause = dt swapped to 0: no step runs and the lagged
        acceleration is kept."""
        if self._old_dt is None:
            self._old_dt, self.dt = self.dt, 0.0
        else:
            self.dt, self._old_dt = self._old_dt, None

    # ------------------------------------------------------------------ run
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, n_steps: int, *, chunk: int = 100) -> SimState:
        """Advance ``n_steps`` in chunks of at most ``chunk`` steps."""
        if self.dt == 0.0:
            return self.state
        remaining = n_steps
        while remaining > 0:
            self._maybe_wrap_box()
            self._maybe_morton_sort()
            k = min(chunk, remaining)
            t0 = time.perf_counter()
            self.state = run_chunk(self._step_fn, self.state, self.dt, self.G, k)
            with span("nbody3d.engine.wait"):
                self._sync()
            elapsed = time.perf_counter() - t0
            self.stats.update(k, elapsed, self.pair_interactions_per_step)
            if self.metrics_path:
                self._append_metrics(k, elapsed)
            remaining -= k
        return self.state

    def step(self, n: int = 1) -> SimState:
        return self.run(n, chunk=n)

    def _event(self):
        """A CUDA event recorded on the device's current stream (None on
        the CPU, where the work is done when the call returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def run_async(self, k: int):
        """Enqueue one chunk of ``k`` steps and return without waiting: a
        token for :meth:`wait_chunk`, or None (and nothing runs) while
        paused.  Work enqueued before this call on the device's stream (a
        frame's :meth:`render_frame_begin`) runs first."""
        if self.dt == 0.0 or k <= 0:
            return None
        self._maybe_wrap_box()
        self._maybe_morton_sort()
        t0 = time.perf_counter()
        self.state = run_chunk(self._step_fn, self.state, self.dt, self.G, k)
        return k, t0, self._event()

    def wait_chunk(self, token) -> None:
        """Wait for the chunk of :meth:`run_async` (its event), then update
        the stats and the metrics with the time from enqueue to done."""
        if token is None:
            return
        k, t0, ev = token
        with span("nbody3d.engine.wait"):
            if ev is not None:
                ev.synchronize()
            elapsed = time.perf_counter() - t0
            self.stats.update(k, elapsed, self.pair_interactions_per_step)
        if self.metrics_path:
            self._append_metrics(k, elapsed)

    def _append_metrics(self, k: int, elapsed: float) -> None:
        rec = {
            "t": time.time(),
            "step": int(self.stats.total_steps),
            "chunk": k,
            "wall_s": round(elapsed, 6),
            "steps_per_s": round(self.stats.steps_per_s, 3),
            "gints_per_s": round(self.stats.gints_per_s, 4),
            "n_bodies": self.n_real,
            "dt": self.dt,
            "G": self.G,
            "device": str(self.device),
        }
        if self.last_render_ms is not None:
            rec["render_ms"] = round(self.last_render_ms, 3)
            rec["render_info"] = self.last_render_info
        a = self.scale_factor
        if a is not None:
            rec["a"] = round(a, 6)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _maybe_wrap_box(self) -> None:
        """Periodic boundary: wrap the stored positions into ``[0, L)³`` at
        chunk boundaries.  The solvers wrap internally every step; this
        keeps checkpoints and frames in canonical coordinates and bounds
        the f32 position magnitudes."""
        if self.config.boundary != "periodic":
            return
        from nbody3d_tpu_torch.ops.ewald import wrap_box

        p = self.state.pos_mass
        wrapped = torch.cat([wrap_box(p[:, :3], self.config.box_size), p[:, 3:4]], dim=1)
        self.state = SimState(wrapped, self.state.vel, self.state.accel, self.state.step)

    def _maybe_morton_sort(self) -> None:
        """Re-sort along the Z-order curve every ``config.morton_every``
        steps, at chunk boundaries."""
        every = self.config.morton_every
        if not every:
            return
        done = self.stats.total_steps
        if done < self._next_morton:
            return
        self._next_morton = done + every
        with span("nbody3d.engine.resort"):
            state = self.global_state()
            p, v, a = morton_reorder(state.pos_mass, state.vel, state.accel, n_real=self.n_real)
            state = SimState(p, v, a, state.step)
            if self.mesh is not None:
                # The same stable sort on every rank; each keeps its own rows.
                state = sharded.shard_state(state, self.mesh)
            self.state = state

    @property
    def scale_factor(self) -> float | None:
        """The background's scale factor ``a(t)`` of a comoving run (None in
        static space), from the host mirror of the step's background
        (``ops/expansion.py::cosmic_time_and_scale``)."""
        if self.config.cosmology == "none":
            return None
        from nbody3d_tpu_torch.ops.expansion import cosmic_time_and_scale

        rho_bar = self._mass_total / float(self.config.box_size) ** 3
        dt = self._old_dt if self._old_dt is not None else self.dt
        return cosmic_time_and_scale(self.config, self.G, rho_bar, self.step_count, dt)[1]

    @property
    def pair_interactions_per_step(self) -> int:
        """N^2 - N per force evaluation, times the integrator's force
        evaluations per step."""
        evals = FORCE_EVALS.get(self.config.integrator, 1)
        return (self.n_real * self.n_real - self.n_real) * evals

    # ---------------------------------------------------------- inspection
    @property
    def step_count(self) -> int:
        return self.state.step

    def global_state(self) -> SimState:
        """The whole padded state: this one, or a sharded one gathered on
        every rank (collective)."""
        if self.mesh is None:
            return self.state
        return sharded.gather_state(self.state, self.mesh)

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host copies of the real (unpadded) pos_mass, vel, accel
        (collective with a mesh)."""
        return unpad(self.global_state(), self.n_real)

    def diagnostics(self, chunk: int | None = 1024) -> diag_mod.Diagnostics:
        """Energy/momentum diagnostics of the padded state on the device
        (mass-0 padding adds zero to every sum), as host numpy values.  On
        the periodic box the potential is the Ewald energy, in float64 on
        the host (:meth:`_periodic_diagnostics`)."""
        if self.config.boundary == "periodic":
            return self._periodic_diagnostics()
        if self.mesh is not None:
            d = self._sharded_diag(self.state, self.G)
            return diag_mod.Diagnostics(*(t.detach().cpu().numpy() for t in d))
        if chunk is not None:
            # Bound the (chunk, N) pair temporaries to ~1 GB each.
            mem_cap = max(8, (1 << 28) // max(self.n_pad, 1))
            chunk = fit_block(self.n_pad, min(chunk, mem_cap))
        d = diag_mod.compute(
            self.state.pos_mass, self.state.vel, self.G,
            eps2=self.config.eps2, chunk=chunk,
        )
        return diag_mod.Diagnostics(*(t.detach().cpu().numpy() for t in d))

    def _periodic_diagnostics(self) -> diag_mod.Diagnostics:
        """The conserved energy of the periodic motion: the Ewald potential
        (``ewald_potential_energy_f64``: a cancellation of ~1e7-1e8 terms
        that f32 cannot resolve), in float64 on the host; O(N²), at the
        diagnostics' cadence.  Padding rows carry zero mass."""
        from nbody3d_tpu_torch.ops.ewald import ewald_potential_energy_f64

        state = self.global_state()
        pm_h = state.pos_mass.detach().cpu().double().numpy()
        vel_h = state.vel.detach().cpu().double().numpy()
        m = pm_h[:, 3:4]
        ke = 0.5 * float(np.sum(m[:, 0] * np.sum(vel_h[:, :3] ** 2, axis=1)))
        pe = float(self.G) * ewald_potential_energy_f64(pm_h, float(self.config.box_size), eps2=self.config.eps2)
        return diag_mod.Diagnostics(
            kinetic=np.float64(ke),
            potential=np.float64(pe),
            total_energy=np.float64(ke + pe),
            momentum=(m * vel_h[:, :3]).sum(axis=0),
            angular_momentum=(m * np.cross(pm_h[:, :3], vel_h[:, :3])).sum(axis=0),
            total_mass=np.float64(m.sum()),
        )

    # ---------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Save a checkpoint; format by suffix: ``.json`` = reference
        schema, ``.npz`` = native, anything else = a checkpoint directory
        (``utils/checkpoint.py``).  With a mesh every rank calls it (the
        state is gathered) and rank 0 writes."""
        from nbody3d_tpu_torch.utils import checkpoint

        if self.mesh is not None and self.mesh.rank != 0:
            self.arrays()  # the gather that rank 0's save makes
            return
        save = {"json": checkpoint.save_reference_json, "npz": checkpoint.save_npz, "dir": checkpoint.save_dir}
        save[checkpoint.check_format(path)](path, self)

    @classmethod
    def load(
        cls, path: str, config: SimConfig | None = None, *, device: torch.device | str | None = None, mesh=None
    ) -> "Simulation":
        """A Simulation on ``device`` (or sharded over ``mesh``: every rank
        reads the checkpoint and keeps its rows) from a ``.json``, ``.npz``
        or directory checkpoint.  ``config=None`` takes the saved one (npz,
        directory) or the defaults with the file's G and dt (JSON)."""
        from nbody3d_tpu_torch.utils import checkpoint

        load = {"json": checkpoint.load_reference_json, "npz": checkpoint.load_npz, "dir": checkpoint.load_dir}
        return load[checkpoint.check_format(path)](path, config, device=device, mesh=mesh)

    # -------------------------------------------------------------- render
    def render_frame(
        self,
        camera=None,
        *,
        width: int = 1024,
        height: int = 768,
        color_mode: str = "magnitude",
        resolve: str = "auto",
    ) -> np.ndarray:
        """Headless point-splat frame of the current state, (H, W, 3) uint8.

        ``resolve="auto"`` renders on the state's device (the
        ``splat_resolve`` kernel on a card) from the real rows only: mass-0
        padding would still splat through the minimum-size clamp.
        ``"host"`` is the JAX package's default f64 host frame, ``"device"``
        its quantized resolve (``render/resolve.py``).  The camera defaults
        to one orbiting ``camera_target``.  With a mesh the call is
        collective and every rank gets the same image (the module's
        docstring).
        """
        from nbody3d_tpu_torch.render.rasterize import render_points
        from nbody3d_tpu_torch.utils.camera import Camera

        if camera is None:
            camera = Camera(target=self.camera_target)
        t0 = time.perf_counter()
        if self.mesh is not None and resolve == "auto":
            img = self._sharded_image(camera, width, height, color_mode).cpu().numpy()
        else:
            pm, vel = self._frame_rows()
            img = render_points(pm, vel, camera, width=width, height=height, size_factor=self.config.size_factor,
                                color_mode=color_mode, resolve=resolve)
        # The image is on the host, so the device's work is done.
        self.last_render_ms = (time.perf_counter() - t0) * 1e3
        self.last_render_info = f"{width}x{height} {camera.describe()}"
        return img

    def _frame_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The real rows a one-device frame renders: this state's, or a
        sharded one's gathered on every rank (collective)."""
        state = self.global_state()
        return state.pos_mass[: self.n_real].detach(), state.vel[: self.n_real].detach()

    def _sharded_words(self, camera, width: int, height: int, color_mode: str) -> torch.Tensor:
        """The merged ``(H * W,)`` framebuffer of the sharded render
        (collective), on this rank's device; the render is cached by frame
        size and colour mode, as the JAX engine's ``_sharded_render``."""
        from nbody3d_tpu_torch.parallel.exchange import DistGroup
        from nbody3d_tpu_torch.render.sharded import make_sharded_render

        key = (width, height, color_mode)
        render = self._sharded_renders.get(key)
        if render is None:
            render = self._sharded_renders[key] = make_sharded_render(
                DistGroup(self.mesh.rank, self.mesh.size), self.n_pad, self.n_real, width=width, height=height,
                size_factor=self.config.size_factor, color_mode=color_mode)
        return render.words([self.state.pos_mass.detach()], [self.state.vel.detach()], camera)

    def _sharded_image(self, camera, width: int, height: int, color_mode: str) -> torch.Tensor:
        """The ``(H, W, 3)`` uint8 image of the sharded render (collective),
        on this rank's device."""
        from nbody3d_tpu_torch.render.resolve import buffer_image

        words = self._sharded_words(camera, width, height, color_mode)
        return buffer_image(words, width=width, height=height)

    def render_frame_collective(
        self, camera=None, *, width: int = 1024, height: int = 768, color_mode: str = "magnitude",
        resolve: str = "auto",
    ) -> None:
        """A mesh rank's share of a frame whose image it does not keep (a
        served mesh's follower, ``viewer.py``): the collective calls of
        :meth:`render_frame` and :meth:`render_frame_begin` alone, in their
        order (the sharded render's prep, resolve and all-reduce for
        ``"auto"``, else the rows' gather), with no image, no copy to the
        host and no host render."""
        from nbody3d_tpu_torch.render.rasterize import RESOLVES
        from nbody3d_tpu_torch.utils.camera import Camera

        if resolve not in RESOLVES:
            raise ValueError(f"unknown resolve {resolve!r} ({', '.join(RESOLVES)})")
        if resolve == "auto":
            self._sharded_words(camera or Camera(target=self.camera_target), width, height, color_mode)
        else:
            self._frame_rows()

    def _to_pinned(self, t: torch.Tensor) -> torch.Tensor:
        """A non-blocking copy of ``t`` into this sim's pinned host buffer of
        its shape and dtype (``t`` itself on the CPU).  One frame is in
        flight at a time: the next copy into the buffer comes after the
        frame's finish."""
        if t.device.type != "cuda":
            return t
        key = (tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def render_frame_begin(
        self,
        camera=None,
        *,
        width: int = 1024,
        height: int = 768,
        color_mode: str = "magnitude",
        resolve: str = "auto",
    ) -> dict:
        """Phase 1 of a pipelined frame, from the current state: for
        ``"auto"`` and ``"device"`` the prep and the resolve are enqueued on
        the device's current stream with a non-blocking copy of the image
        (or the quantized buffer) into a pinned host buffer and an event
        after it, with no host sync; a chunk enqueued next runs after them.
        ``"host"`` copies the state to the host here.  With a mesh the call
        is collective: ``"auto"`` enqueues the sharded render (each rank's
        prep and resolve, the frames' all-reduce) the same way, with no host
        sync, and the other resolves gather the rows first.  Returns the
        handle of :meth:`render_frame_finish`."""
        from nbody3d_tpu_torch.render import rasterize, resolve as rs
        from nbody3d_tpu_torch.utils.camera import Camera

        if resolve not in rasterize.RESOLVES:
            raise ValueError(f"unknown resolve {resolve!r} ({', '.join(rasterize.RESOLVES)})")
        if camera is None:
            camera = Camera(target=self.camera_target)
        t0 = time.perf_counter()
        handle = {"camera": camera, "width": width, "height": height, "color_mode": color_mode,
                  "resolve": resolve}
        if self.mesh is not None and resolve == "auto":
            handle["host"] = self._to_pinned(self._sharded_image(camera, width, height, color_mode))
            handle["event"] = self._event()
            handle["begin_ms"] = (time.perf_counter() - t0) * 1e3
            return handle
        pm, vel = self._frame_rows()
        if resolve == "host":
            handle["src"] = (pm.cpu().numpy(), vel.cpu().numpy())
        else:
            prep = rasterize.prep_device(pm, vel, camera, width, height, self.config.size_factor, 64, color_mode)
            if resolve == "auto":
                buf = rs.splat_resolve(*prep, width=width, height=height)
                handle["host"] = self._to_pinned(rs.buffer_image(buf, width=width, height=height))
            else:
                handle["host"] = self._to_pinned(rs.quantized_scatter(*prep, width=width, height=height))
                handle["prep"] = prep
            handle["event"] = self._event()
        handle["begin_ms"] = (time.perf_counter() - t0) * 1e3
        return handle

    def _large_splats(self, prep, event):
        """The quantized frame's large splats, fetched on a side stream that
        waits for the frame's event alone (the current stream has the
        chunk after it); each prep tensor is recorded on that stream."""
        from nbody3d_tpu_torch.render import resolve as rs

        if event is None:
            return rs.quantized_large(*prep)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(device=self.device)
        side = self._side_stream
        side.wait_event(event)
        with torch.cuda.stream(side):
            for t in prep:
                t.record_stream(side)
            return rs.quantized_large(*prep)

    def render_frame_finish(self, handle: dict) -> np.ndarray:
        """Phase 2 of a pipelined frame: wait for the frame's event (not the
        chunk's), then finish on the host: the image itself (``"auto"``),
        the large splats stamped and the colours decoded (``"device"``), or
        the host render (``"host"``).  Returns the (H, W, 3) uint8 image;
        :attr:`last_render_ms` is the begin's ms plus the finish's."""
        from nbody3d_tpu_torch.render import rasterize, resolve as rs

        t0 = time.perf_counter()
        w, h, cam = handle["width"], handle["height"], handle["camera"]
        if handle["resolve"] == "host":
            img = rasterize.render_points(*handle["src"], cam, width=w, height=h,
                                          size_factor=self.config.size_factor,
                                          color_mode=handle["color_mode"], resolve="host")
        else:
            if handle["event"] is not None:
                handle["event"].synchronize()
            if handle["resolve"] == "auto":
                img = handle["host"].numpy().copy()
            else:
                large = self._large_splats(handle["prep"], handle["event"])
                buf = rs.quantized_frame(handle["host"], large, width=w, height=h)
                img = rs.quantized_image(buf, width=w, height=h)
        self.last_render_ms = handle["begin_ms"] + (time.perf_counter() - t0) * 1e3
        self.last_render_info = f"{w}x{h} {cam.describe()}"
        return img

    # ------------------------------------------------------------- logging
    def log_lines(self) -> Iterator[str]:
        s = self.stats
        a = self.scale_factor
        yield (
            f"step={self.step_count} steps/s={s.steps_per_s:.2f} "
            f"Gints/s={s.gints_per_s:.2f} wall_ms/step={s.ms_per_step:.3f} "
            f"N={self.n_real} dt={self.dt:g} G={self.G:g}"
            + (f" a={a:.4f}" if a is not None else "")
            + f" device={self.device}"
        )
        if self.last_render_ms is not None:
            yield f"  render_ms={self.last_render_ms:.1f} {self.last_render_info}"
