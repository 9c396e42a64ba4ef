"""EMA-filtered step timing and the pair-interaction rate.

Step times are host wall clock around a chunk of steps that ends in a
device synchronize (``Simulation.run``), smoothed with the reference HUD's
update rule ``x += (sample - x) / filterStrength``.
"""

from __future__ import annotations

import dataclasses
import time


class Ema:
    """Exponential moving average, ``x += (sample - x) / filter_strength``."""

    def __init__(self, filter_strength: float = 10.0):
        self.filter_strength = filter_strength
        self.value = 0.0
        self._initialized = False

    def update(self, sample: float) -> float:
        if not self._initialized:
            self.value = sample
            self._initialized = True
        else:
            self.value += (sample - self.value) / self.filter_strength
        return self.value


@dataclasses.dataclass
class StepStats:
    """Running stats over :meth:`update` calls (one call per chunk)."""

    ema: Ema = dataclasses.field(default_factory=Ema)
    total_steps: int = 0
    total_time: float = 0.0
    steps_per_s: float = 0.0
    ms_per_step: float = 0.0
    gints_per_s: float = 0.0

    def update(self, steps: int, elapsed_s: float, pair_interactions: int) -> None:
        self.total_steps += steps
        self.total_time += elapsed_s
        per_step = elapsed_s / max(steps, 1)
        self.ms_per_step = self.ema.update(per_step * 1e3)
        if per_step > 0:
            self.steps_per_s = 1.0 / per_step
            self.gints_per_s = pair_interactions / per_step / 1e9
        else:
            self.steps_per_s = float("inf")
            self.gints_per_s = float("inf")


class Timer:
    """perf_counter timer usable as a context manager."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
