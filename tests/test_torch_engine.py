"""The slice as a whole on the CPU: the port's Simulation against the JAX
package's, the CLI, the dispatch rules, and the import boundary."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation  # noqa: E402
from nbody3d_tpu_torch import cli  # noqa: E402
from nbody3d_tpu_torch.ops.launch import KERNELS, launch_counts, reset_launch_counts  # noqa: E402


def run_both(kw_torch, kw_jax, n=600, steps=3):
    ts = Simulation.from_preset("plummer", SimConfig(**kw_torch), n=n, device="cpu")
    js = JaxSimulation.from_preset("plummer", JaxConfig(**kw_jax), n=n, platform="cpu")
    ts.run(steps, chunk=steps)
    js.run(steps, chunk=steps)
    assert ts.step_count == js.step_count == steps
    return ts, js


def assert_real_rows_close(ts, js, accel_rtol):
    (tp, tv, ta), (jp, jv, ja) = ts.arrays(), js.arrays()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5 * np.abs(jv).max())
    assert np.abs(ta - ja).max() / np.abs(ja).max() < accel_rtol


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_exact_mode_matches_jax_simulation(backend):
    """Exact force: the oracle route (jnp) and the kernel route (on CPU:
    force_exact's plain twin) against the JAX package's jnp engine.  Three
    f32 steps with different summation orders: accel within 1e-5 of
    scale, positions within 1e-6."""
    ts, js = run_both({"backend": backend}, {"backend": "jnp"})
    assert ts.n_pad == (600 if backend == "jnp" else 768)
    assert_real_rows_close(ts, js, 1e-5)


def test_sym_mode_matches_jax_fused_step():
    """The fused sym step (on CPU: the three plain stages) against the JAX
    package's fused sym step in interpret mode; the fused-step bound 5e-5."""
    ts, js = run_both(
        {"force_mode": "sym", "block_target": 256},
        {"force_mode": "sym", "block_target": 256, "backend": "pallas"},
    )
    assert ts.n_pad == 768  # 3 tiles of 256: odd nt, padded
    assert_real_rows_close(ts, js, 5e-5)


def test_diagnostics_and_morton_engine():
    ts, js = run_both({"morton_every": 2}, {"morton_every": 2, "backend": "jnp"}, n=300, steps=4)
    dt, dj = ts.diagnostics(), js.diagnostics()
    np.testing.assert_allclose(float(dt.total_energy), float(dj.total_energy), rtol=1e-5)
    pj = np.asarray(dj.momentum)
    assert np.abs(dt.momentum - pj).max() <= 1e-5 * np.abs(pj).max()
    assert ts.pair_interactions_per_step == js.pair_interactions_per_step == 300 * 299


def test_pause_and_sliders():
    sim = Simulation.from_preset("uniform-sphere", SimConfig(), n=64, device="cpu")
    sim.toggle_pause()
    assert sim.paused and sim.dt == 0.0
    sim.run(5)
    assert sim.step_count == 0
    sim.toggle_pause()
    sim.G = 2e-4
    sim.step(2)
    assert sim.step_count == 2 and sim.G == 2e-4
    assert sim.stats.total_steps == 2


def test_metrics_jsonl(tmp_path):
    sim = Simulation.from_preset("uniform-sphere", SimConfig(), n=64, device="cpu")
    sim.metrics_path = str(tmp_path / "m.jsonl")
    sim.run(4, chunk=2)
    recs = [json.loads(line) for line in open(sim.metrics_path)]
    assert [r["step"] for r in recs] == [2, 4]
    assert recs[0]["device"] == "cpu" and recs[0]["n_bodies"] == 64


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation.from_preset("uniform-sphere", SimConfig(), n=64, device="cuda")


def test_pallas_backend_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        Simulation.from_preset("uniform-sphere", SimConfig(backend="pallas"), n=64, device="cpu")


@pytest.mark.parametrize(
    "kw",
    [
        {"force_mode": "fast"},
        {"method": "pm"},
        {"method": "p3m"},
        {"boundary": "periodic", "box_size": 10.0},
        {"cosmology": "eds"},
        {"fuse_integrate": True},
        {"force_mode": "sym", "integrator": "yoshida4"},
        {"force_mode": "sym", "fuse_epilogue": False},
        {"force_mode": "sym", "block_target": 512},  # one tile: nt = 1
    ],
)
def test_unported_configs_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Simulation.from_preset("uniform-sphere", SimConfig(**kw), n=256, device="cpu")


def test_launch_counters_stay_zero_on_cpu():
    reset_launch_counts()
    for mode in ("exact", "sym"):
        sim = Simulation.from_preset("uniform-sphere", SimConfig(force_mode=mode), n=512, device="cpu")
        sim.run(2)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_cli_run_bench_info(capsys, tmp_path):
    assert cli.main(["run", "--device", "cpu", "--preset", "uniform-sphere", "--n", "128",
                     "--steps", "4", "--log-every", "2", "--diagnostics", "--outdir", str(tmp_path),
                     "--log-dt", "-3", "--log-G", "-4"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert sum(line.startswith("step=") for line in lines) == 2 and "E=" in out and "device=cpu" in out
    assert "dt=0.001 G=0.0001" in out
    assert cli.main(["bench", "--device", "cpu", "--n", "128", "--steps", "4", "--chunk", "2",
                     "--warmup-steps", "2", "--force-mode", "sym", "--block-target", "64"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["n_bodies"] == 128 and rec["force_mode"] == "sym" and rec["gints_per_s"] > 0
    assert cli.main(["info"]) == 0
    assert "torch" in json.loads(capsys.readouterr().out)


@pytest.mark.parametrize(
    "n,want", [(40192, 256), (768, 2048), (600, 256), (1000, 64), (97, 16), (262144, 1024)]
)
def test_block_fitting_matches_jax(n, want):
    from nbody3d_tpu.ops.blocks import divisor_block as jax_divisor_block
    from nbody3d_tpu.ops.step import fit_block as jax_fit_block
    from nbody3d_tpu_torch.ops.blocks import divisor_block
    from nbody3d_tpu_torch.ops.step import fit_block

    assert divisor_block(n, want) == jax_divisor_block(n, want)
    try:
        want_fit = jax_fit_block(n, want)
    except ValueError:
        with pytest.raises(ValueError):
            fit_block(n, want)
    else:
        assert fit_block(n, want) == want_fit


def test_step_stats_match_jax():
    from nbody3d_tpu.utils.profiling import StepStats as JaxStepStats
    from nbody3d_tpu_torch.utils.profiling import StepStats, Timer

    ts, js = StepStats(), JaxStepStats()
    for steps, secs in [(50, 0.0748), (50, 0.0751), (10, 0.0), (100, 0.149)]:
        ts.update(steps, secs, 40002 * 40001)
        js.update(steps, secs, 40002 * 40001)
    assert dataclasses.astuple(ts)[1:] == dataclasses.astuple(js)[1:]
    assert ts.ema.value == js.ema.value
    with Timer() as t:
        sum(range(1000))
    assert t.elapsed > 0


def test_port_imports_without_jax():
    """The package, every module of it and chip_smoke.py import with jax
    and PIL blocked, and pull in nothing of nbody3d_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['PIL'] = None\n"
        "import nbody3d_tpu_torch, nbody3d_tpu_torch.cli, nbody3d_tpu_torch._build\n"
        "import nbody3d_tpu_torch.ops.step, nbody3d_tpu_torch.ops.cuda_force\n"
        "import nbody3d_tpu_torch.ops.diagnostics, nbody3d_tpu_torch.ops.morton\n"
        "import nbody3d_tpu_torch.models, nbody3d_tpu_torch.utils.profiling\n"
        "import nbody3d_tpu_torch.ops.force_vjp, nbody3d_tpu_torch.utils.checkpoint\n"
        "import nbody3d_tpu_torch.utils.camera, nbody3d_tpu_torch.utils.mathlib\n"
        "import nbody3d_tpu_torch.render.rasterize, nbody3d_tpu_torch.render.resolve\n"
        "import nbody3d_tpu_torch.render.image, nbody3d_tpu_torch.render.colormap\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'nbody3d_tpu' or m.startswith('nbody3d_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=pathlib.Path(__file__).resolve().parents[1],
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
