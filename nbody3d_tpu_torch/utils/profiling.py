"""EMA-filtered step timing, the pair-interaction rate, device traces and
the program's spans.

Step times are host wall clock around a chunk of steps that ends in a
device synchronize (``Simulation.run``), smoothed with the reference HUD's
update rule ``x += (sample - x) / filterStrength``.  :func:`device_trace`
is the deep dive: a ``torch.profiler`` Chrome trace around a block.

:func:`span` is the program's one way to open a span: a named host range
on the profiler's clock, recorded only while a ``torch.profiler`` records
on the calling thread (autograd's device thread inherits the profiler's
state, so a span inside a backward is recorded too), and one flag check
otherwise.  A span is a host event alone: ``torch.profiler.record_function``
would also put a device-side copy of the range into the trace (a
``gpu_user_annotation`` that covers the idle gaps between the range's
kernels), so spans take the profiler's plain function-scope record.
:data:`SPANS` names every span the package opens and the per-layer
metrics of ``nbbench/`` that read it; the spans show in ``run --trace``'s
Chrome trace and in any profiler window around the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
from torch._C._profiler import _RecordFunctionFast

# Every span the package opens, with the per-layer metrics that read it;
# ``syncs_per_step.step`` and ``.grad`` count the blocking CUDA runtime
# calls that lie inside any of them.
SPANS = (
    ("nbody3d.engine.resort", ("resort_ms.step",)),  # the Morton re-sort, when it sorts
    ("nbody3d.engine.wait", ("boundary_idle_ms.step",)),  # a chunk's blocking wait
    ("nbody3d.step", ("dispatch_ms.step", "dispatch_ms.grad")),  # one step of make_step_fn, any route
    ("nbody3d.vjp", ("vjp_host_ms.grad",)),  # the backward of each torch.autograd.Function
)

_OFF = contextlib.nullcontext()


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


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this thread: the gate of
    every :func:`span`."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A context manager that records ``name`` as a host range while a
    profiler records, and does nothing (one flag check) otherwise."""
    return _RecordFunctionFast(name) if recording() else _OFF


@contextlib.contextmanager
def device_trace(path: str | None):
    """A ``torch.profiler`` trace of the block (host ops, and the CUDA
    kernels where there is a card), written as ``<path>/trace.json`` for
    chrome://tracing or Perfetto; nothing when ``path`` is None.  The
    counterpart of the JAX package's ``jax.profiler`` trace."""
    if path is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
