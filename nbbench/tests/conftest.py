"""The benchmark's own tests: ``python -m pytest nbbench/tests -q`` from the
checkout's root.  They run on the CPU at small sizes; a test marked
``card`` needs a CUDA card and skips without one, decided in the
``cuda_device`` fixture."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")


def small_cell(name: str, n: int):
    """A cell of ``BENCHMARK.json`` with its configuration cut to ``n``
    bodies, for the CPU."""
    from nbbench import harness

    cell = harness.load_cell(name)
    cell.config = {**cell.config, "n": n}
    return cell
