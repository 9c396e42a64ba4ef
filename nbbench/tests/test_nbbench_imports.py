"""Nothing of the benchmark imports JAX or the JAX package, compared by the
whole top-level name (``nbody3d_tpu_torch`` is the port, ``nbody3d_tpu``
is not); only the traffic kinds import the port, and the reference, the
inputs and the yardstick import nothing of it."""

import ast
import subprocess
import sys

import pytest

from nbbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.relative_to(harness.HERE).parts)


def _imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                tops.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                tops.add(arg.values[0].value.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_and_the_port_only_in_the_kinds(path):
    tops = _imports(path)
    assert not tops & {"jax", "jaxlib", "flax", "nbody3d_tpu"}, tops
    rel = path.relative_to(harness.HERE).parts
    if "nbody3d_tpu_torch" in tops:
        assert rel[0] == "kinds", path


def test_the_port_is_not_taken_for_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "nbody3d_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "nbody3d_tpu_torch_fake.sub" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nbody3d_tpu.ops", object())
    assert "nbody3d_tpu.ops" in harness.forbidden_modules()


def test_a_run_of_each_kind_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from nbbench import harness\n"
        "from nbbench.tests.conftest import small_cell\n"
        "for name, n in (('sphere262k-sym.step', 512), ('galaxy40k-exact.grad', 256)):\n"
        "    cell = small_cell(name, n)\n"
        "    harness.kind_module(cell.traffic['kind']).run(cell, 5, 0.1, True, torch.device('cpu'), time.perf_counter())\n"
        "print('FOUND', harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout
