"""The command itself: no result without a card, none in a directory that
holds only BENCHMARK.json and the benchmark, and the result line's layout."""

import json
import shutil
import subprocess
import sys

from nbbench import harness


def test_no_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "nbbench/run.py", "--workload", "galaxy40k-exact.step", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "nbbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from nbbench import harness\n"
        "cell = harness.load_cell('galaxy40k-exact.step')\n"
        "harness.kind_module('step').run(cell, 1, 0.1, False, torch.device('cpu'), time.perf_counter())\n"
        "print('{}')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "nbody3d_tpu_torch" in out.stderr
    assert "{" not in out.stdout


def test_result_line_ends_with_the_checks(capsys):
    ok, checks = harness.judge({"force_err": 1e-7, "start_err": 0.0}, {"force_err": 1e-5, "start_err": 0.0})
    harness.emit({"correct": ok, "attempted": 3, "failed": 0, "metrics": {}, "device": {}}, checks)
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert cap.err.strip().splitlines()[-1] == "check start_err 0.0 limit 0.0"
