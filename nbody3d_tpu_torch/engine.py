"""Simulation engine: owns the state on one device, steps it in chunks.

The host sees the state at chunk boundaries only (logging, diagnostics,
Morton re-sorts, checkpoints, frames).  Each chunk is timed on the host
clock and ends in ``torch.cuda.synchronize`` on a CUDA device, so the time
covers the device's work and not just its enqueueing.  Frames render on
the state's device (``render/``: the ``splat_resolve`` kernel on a card);
only the finished image comes to the host.
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
from nbody3d_tpu_torch.state import SimState, init_state, pad_count, unpad
from nbody3d_tpu_torch.utils.profiling import Ema, StepStats


class Simulation:
    """A :class:`SimState` on ``device``, its step function and run
    bookkeeping.  ``device`` is required: ``"cuda"`` raises where there is
    no card, and nothing moves to another device behind the caller."""

    def __init__(
        self,
        config: SimConfig,
        pos_mass: np.ndarray,
        vel: np.ndarray,
        accel: np.ndarray | None = None,
        *,
        device: torch.device | str,
        step: int = 0,
        camera_target: np.ndarray | None = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        # The camera's orbit centre (a preset's third return value), and the
        # full camera pose of a loaded checkpoint (util.js:247-258).
        self.camera_target = (
            np.zeros(3) if camera_target is None else np.asarray(camera_target, dtype=np.float64)
        )
        self.loaded_camera = None
        self.n_real = int(np.asarray(pos_mass).shape[0])
        self.n_pad = pad_count(self.n_real, pad_multiple(config, self.device))
        self.state = init_state(
            pos_mass, vel, accel, n_pad=self.n_pad, step=step, device=self.device
        )
        self._step_fn = make_step_fn(config, self.n_pad, self.n_real, self.device)
        # Live sliders and pause (dt swapped to 0 through _old_dt).
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

    @classmethod
    def from_preset(
        cls,
        name: str,
        config: SimConfig | None = None,
        *,
        device: torch.device | str,
        n: int | None = None,
        **preset_kw,
    ) -> "Simulation":
        config = config or SimConfig()
        pos_mass, vel, target = make_preset(
            name, seed=config.seed, G=config.G, n=n,
            size_factor=config.size_factor, **preset_kw,
        )
        return cls(config, pos_mass, vel, device=device, camera_target=target)

    # -------------------------------------------------- live dt/G (sliders)
    @property
    def dt(self) -> float:
        return self._dt

    @dt.setter
    def dt(self, v: float) -> None:
        self._dt = float(v)

    @property
    def G(self) -> float:
        return self._G

    @G.setter
    def G(self, v: float) -> None:
        self._G = float(v)

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
            self._maybe_morton_sort()
            k = min(chunk, remaining)
            t0 = time.perf_counter()
            self.state = run_chunk(self._step_fn, self.state, self.dt, self.G, k)
            self._sync()
            elapsed = time.perf_counter() - t0
            self.stats.update(k, elapsed, self.pair_interactions_per_step)
            if self.metrics_path:
                self._append_metrics(k, elapsed)
            remaining -= k
        return self.state

    def step(self, n: int = 1) -> SimState:
        return self.run(n, chunk=n)

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
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

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
        p, v, a = morton_reorder(
            self.state.pos_mass, self.state.vel, self.state.accel, n_real=self.n_real
        )
        self.state = SimState(p, v, a, self.state.step)

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

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host copies of the real (unpadded) pos_mass, vel, accel."""
        return unpad(self.state, self.n_real)

    def diagnostics(self, chunk: int | None = 1024) -> diag_mod.Diagnostics:
        """Energy/momentum diagnostics of the padded state on the device
        (mass-0 padding adds zero to every sum), as host numpy values."""
        if chunk is not None:
            # Bound the (chunk, N) pair temporaries to ~1 GB each.
            mem_cap = max(8, (1 << 28) // max(self.n_pad, 1))
            chunk = fit_block(self.n_pad, min(chunk, mem_cap))
        d = diag_mod.compute(
            self.state.pos_mass, self.state.vel, self.G,
            eps2=self.config.eps2, chunk=chunk,
        )
        return diag_mod.Diagnostics(*(t.detach().cpu().numpy() for t in d))

    # ---------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Save a checkpoint; format by suffix: ``.json`` = reference
        schema, ``.npz`` = native (``utils/checkpoint.py``)."""
        from nbody3d_tpu_torch.utils import checkpoint

        if checkpoint.check_format(path) == "json":
            checkpoint.save_reference_json(path, self)
        else:
            checkpoint.save_npz(path, self)

    @classmethod
    def load(
        cls, path: str, config: SimConfig | None = None, *, device: torch.device | str
    ) -> "Simulation":
        """A Simulation on ``device`` from a ``.json`` or ``.npz`` checkpoint.
        ``config=None`` takes the file's (npz) or the defaults with the file's
        G and dt (JSON)."""
        from nbody3d_tpu_torch.utils import checkpoint

        if checkpoint.check_format(path) == "json":
            return checkpoint.load_reference_json(path, config, device=device)
        return checkpoint.load_npz(path, config, device=device)

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
        ``"host"`` is the JAX package's default f64 host frame.  The camera
        defaults to one orbiting ``camera_target``.
        """
        from nbody3d_tpu_torch.render.rasterize import render_points
        from nbody3d_tpu_torch.utils.camera import Camera

        if camera is None:
            camera = Camera(target=self.camera_target)
        t0 = time.perf_counter()
        img = render_points(
            self.state.pos_mass[: self.n_real].detach(),
            self.state.vel[: self.n_real].detach(),
            camera,
            width=width,
            height=height,
            size_factor=self.config.size_factor,
            color_mode=color_mode,
            resolve=resolve,
        )
        # The image is on the host, so the device's work is done.
        self.last_render_ms = (time.perf_counter() - t0) * 1e3
        self.last_render_info = f"{width}x{height} {camera.describe()}"
        return img

    # ------------------------------------------------------------- logging
    def log_lines(self) -> Iterator[str]:
        s = self.stats
        yield (
            f"step={self.step_count} steps/s={s.steps_per_s:.2f} "
            f"Gints/s={s.gints_per_s:.2f} wall_ms/step={s.ms_per_step:.3f} "
            f"N={self.n_real} dt={self.dt:g} G={self.G:g} device={self.device}"
        )
        if self.last_render_ms is not None:
            yield f"  render_ms={self.last_render_ms:.1f} {self.last_render_info}"
