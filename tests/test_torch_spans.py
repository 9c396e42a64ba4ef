"""The program's spans (``utils/profiling.py``): ``span`` opens nothing
while no profiler records, and under ``torch.profiler`` the engine, the
step and the force VJP open exactly the spans ``SPANS`` names, one a unit
of work, on the exact, fused sym and unfused sym routes (the kernels'
plain twins on the CPU)."""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import nbody3d_tpu_torch  # noqa: E402
from nbody3d_tpu_torch import SimConfig, SimState, Simulation, init_state, pad_count  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn, pad_multiple  # noqa: E402
from nbody3d_tpu_torch.utils import profiling  # noqa: E402

PACKAGE = pathlib.Path(nbody3d_tpu_torch.__file__).parent
NAMES = {name for name, _ in profiling.SPANS}
# 300 bodies pad to 512 on the kernel route: two sym tiles of 256, so the
# sym configuration takes the fused step.
N = 300
ROUTES = {
    "exact": {},
    "sym_fused": {"force_mode": "sym"},
    "sym_unfused": {"force_mode": "sym", "fuse_epilogue": False},
}
CHUNKS = 3  # of one step each; morton_every=2 sorts before the first and the third
SORTS = 2
ROLLOUT = 3


def _inputs():
    rng = np.random.default_rng(7)
    pos_mass = np.concatenate([rng.normal(size=(N, 3)), rng.uniform(0.5, 1.5, (N, 1))], axis=1)
    vel = np.concatenate([0.1 * rng.normal(size=(N, 3)), np.zeros((N, 1))], axis=1)
    return pos_mass.astype(np.float32), vel.astype(np.float32)


def _sim(route: str) -> Simulation:
    pos_mass, vel = _inputs()
    return Simulation(SimConfig(morton_every=2, **ROUTES[route]), pos_mass, vel, device="cpu")


def _drive_async(sim: Simulation) -> None:
    for _ in range(CHUNKS):
        sim.wait_chunk(sim.run_async(1))


def _drive_run(sim: Simulation) -> None:
    sim.run(CHUNKS, chunk=1)


def _gradient(route: str) -> torch.Tensor:
    """The gradient by v0 of mean |x|^2 after a ``ROLLOUT``-step rollout
    through ``make_step_fn`` (the benchmark's gradient, at a small N)."""
    cfg = SimConfig(**ROUTES[route])
    pos_mass, vel = _inputs()
    st = init_state(pos_mass, vel, n_pad=pad_count(N, pad_multiple(cfg, "cpu")), device="cpu")
    step = make_step_fn(cfg, st.n_pad, N, "cpu")
    v = st.vel.detach().requires_grad_()
    s = SimState(st.pos_mass, v, torch.zeros_like(st.pos_mass), 0)
    for _ in range(ROLLOUT):
        s = step(s, cfg.dt, cfg.G)
    return torch.autograd.grad((s.pos_mass[:, :3] ** 2).sum() / N, v)[0]


def _spans(fn) -> dict[str, list[tuple[float, float]]]:
    """The program's spans that ``fn()`` opens under a CPU profiler, by
    name, as (start, end) in microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out: dict[str, list] = {name: [] for name in NAMES}
    for e in prof.events():
        if e.name in NAMES:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def _raise(*a, **k):
    raise AssertionError("a span was recorded with no profiler running")


@pytest.mark.parametrize("drive", [_drive_async, _drive_run], ids=["run_async", "run"])
def test_no_profiler_records_no_span(monkeypatch, drive):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    sim = _sim("sym_fused")
    drive(sim)
    assert sim.stats.total_steps == CHUNKS
    assert torch.isfinite(_gradient("exact")).all()


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("drive", [_drive_async, _drive_run], ids=["run_async", "run"])
def test_engine_spans_one_a_unit(route, drive):
    sim = _sim(route)
    spans = _spans(lambda: drive(sim))
    assert len(spans["nbody3d.step"]) == CHUNKS
    assert len(spans["nbody3d.engine.wait"]) == CHUNKS
    assert len(spans["nbody3d.engine.resort"]) == SORTS
    assert spans["nbody3d.vjp"] == []
    for s0, s1 in spans["nbody3d.step"]:
        assert not any(w0 <= s0 and s1 <= w1 for w0, w1 in spans["nbody3d.engine.wait"])


@pytest.mark.parametrize("route", list(ROUTES))
def test_gradient_spans_one_a_rollout_step(route):
    spans = _spans(lambda: _gradient(route))
    assert len(spans["nbody3d.step"]) == ROLLOUT
    # The frame-shifted Verlet takes the force at a step's own positions:
    # the first step's, at x0, needs no gradient by v0, so autograd runs no
    # VJP for it on the exact and unfused routes; the fused sym step's
    # backward runs every step and skips the force VJP inside.
    assert len(spans["nbody3d.vjp"]) == ROLLOUT - (route != "sym_fused")
    assert spans["nbody3d.engine.wait"] == spans["nbody3d.engine.resort"] == []
    # The backward runs after the forward: no VJP inside a step.
    last_step = max(e for _, e in spans["nbody3d.step"])
    assert all(s >= last_step for s, _ in spans["nbody3d.vjp"])


def test_gate_reads_the_profiler():
    assert not profiling.recording()
    assert profiling.span("nbody3d.step") is profiling.span("nbody3d.vjp")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        assert profiling.span("nbody3d.step") is not profiling.span("nbody3d.step")
    assert not profiling.recording()


def test_a_span_is_a_host_op_alone():
    """A span is recorded as a function-scope host op, not as a user
    annotation: on a card the profiler copies a user annotation onto the
    device's timeline, where it would count as device work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("nbody3d.step"):
            torch.ones(4).sum()
    (e,) = [e for e in prof.events() if e.name == "nbody3d.step"]
    assert e.device_type == torch.autograd.DeviceType.CPU
    assert not e.is_user_annotation


def test_every_span_is_listed_and_opened():
    opened, raw = set(), []
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        opened |= set(re.findall(r'\bspan\("([^"]+)"\)', text))
        if path.name != "profiling.py":
            raw += [str(path) for w in ("record_function", "_RecordFunctionFast") if w in text]
    assert opened == NAMES
    assert len(profiling.SPANS) == len(NAMES)
    assert raw == [], "spans go through utils/profiling.span"


def test_cli_trace_holds_the_spans(tmp_path):
    import json

    from nbody3d_tpu_torch import cli

    trace = tmp_path / "trace"
    assert cli.main(["run", "--device", "cpu", "--preset", "uniform-sphere", "--n", "128", "--steps", "4",
                     "--log-every", "2", "--morton-every", "2", "--trace", str(trace),
                     "--outdir", str(tmp_path / "out")]) == 0
    names = [e.get("name") for e in json.loads((trace / "trace.json").read_text())["traceEvents"]]
    assert names.count("nbody3d.step") == 4
    assert names.count("nbody3d.engine.wait") == names.count("nbody3d.engine.resort") == 2
