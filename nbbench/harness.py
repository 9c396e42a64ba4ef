"""What every cell shares: finding its pieces by name, the device report,
the profiled stretch, the per-layer readers and the result line.

A cell ``<name>`` is ``workloads/<name>.json``; it names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``),
whose ``kind`` names the module that drives the program
(``kinds/<kind>.py``).  A per-layer metric ``<metric>`` is read by
``metrics/<metric>.py``.  ``BENCHMARK.json`` at the checkout's root says
which metrics a cell reports.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules that no process of the benchmark may hold once the window has
# closed, compared by the whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "nbody3d_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell's workload, configuration and traffic files, and the
    metrics ``BENCHMARK.json`` gives it."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = {**load_json(HERE / "workloads" / f"{name}.json"), **entry}
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=name, workload=workload, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def kind_module(kind: str):
    return importlib.import_module(f"nbbench.kinds.{kind}")


def generator(name: str):
    return importlib.import_module(f"nbbench.inputs.{name}")


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nbbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_inputs(cell: Cell, seed: int) -> tuple[np.ndarray, np.ndarray]:
    cfg = cell.config
    return generator(cfg["generator"]).make({**cfg["sim"], "n": cfg["n"]}, seed)


# ------------------------------------------------------------- the device
def device_report(torch, dev, chips: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(dev),
        "count": chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e})"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------- the trace
class Stretch:
    """A ``torch.profiler`` window over whole units of work (chunks or
    gradients): device operations and host operations as
    ``(name, start_us, end_us)``, read once the profiler has stopped."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.units = 0
        self.window_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def warm(self, fn) -> None:
        """Start and stop the profiler once around ``fn()`` in the set-up:
        its first start (CUPTI's) takes seconds, which the window must not
        hold."""
        self.start()
        fn()
        self.stop()
        self.prof = None

    def events(self) -> tuple[list, list]:
        device, host = [], []
        if self.prof is None:
            return device, host
        cuda = self.torch.autograd.DeviceType.CUDA
        for e in self.prof.events():
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            (device if e.device_type == cuda else host).append(row)
        return device, host


def trace_record(stretch: Stretch, *, steps: int, pair_bound_s: float, spans: dict) -> dict:
    """What the per-layer readers read: the device and host events of the
    stretch, its wall time, its steps, the configuration's least time a
    step, and the benchmark's host spans."""
    from nbbench.yardstick import busy_union

    device, host = stretch.events()
    busy_s = busy_union([(s, e) for _, s, e in device]) * 1e-6
    return {
        "device_events": device, "host_events": host, "busy_s": busy_s,
        "window_s": stretch.window_s, "steps": steps, "units": stretch.units,
        "pair_bound_s": pair_bound_s, "spans": spans,
    }


def op_name(name: str) -> str:
    """A device operation's name without ``void``, the anonymous namespace
    and the parameter list, at most 120 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if name.endswith(")") and ("::" in name or "kernel" in name):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.strip()[:120]


def breakdown(record: dict) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each gap named by the innermost host operation running at its
    middle (at most 10 of each, seconds as measured)."""
    from nbbench.yardstick import idle_gaps

    per_op: dict[str, float] = {}
    for name, s, e in record["device_events"]:
        per_op[op_name(name)] = per_op.get(op_name(name), 0.0) + (e - s) * 1e-6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps([(s, e) for _, s, e in record["device_events"]]), key=lambda g: g[0] - g[1])[:10]
    named = []
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        over = [(e - s, n) for n, s, e in record["host_events"] if s <= mid <= e]
        named.append([min(over)[1] if over else "python (no host op)", (hi - lo) * 1e-6])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


# ------------------------------------------------------------- the result
def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Each number beside its limit; ``correct`` when every number is at or
    under its limit (a NaN is not)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        good = bool(value <= limit)
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines of standard error, and the result as
    the last line of standard output, with the checks under their key last."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
