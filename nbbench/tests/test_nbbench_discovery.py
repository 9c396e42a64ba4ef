"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its name."""

import json
import re

import pytest

from nbbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nbbench"]
    assert BENCH["command"] == ["python3", "nbbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_with_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["source"].startswith("https://")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_configs_files_and_use():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"nbbench/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert data["precision"] == "float32" and harness.generator(data["generator"]).make


def test_cells_are_unique_pairs_on_one_chip():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS and cell in moved.get("workloads", CELLS)
    for name, m in e2e.items():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_pieces(name):
    cell = harness.load_cell(name, BENCH)
    kind = harness.kind_module(cell.traffic["kind"])
    assert callable(kind.run)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert set(cell.workload["limits"]) >= {"start_err"}
    assert all(float(v) >= 0 for v in cell.workload["limits"].values())


def test_every_file_of_a_piece_is_named_by_benchmark_json():
    here = harness.HERE
    metrics = {m["name"] for m in BENCH["per_layer"]}
    assert {p.name[:-3] for p in (here / "metrics").glob("*.py")} == metrics
    assert {p.stem for p in (here / "workloads").glob("*.json")} == set(CELLS)
    assert {p.stem for p in (here / "traffic").glob("*.json")} == {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (here / "configs").glob("*.json")} == {c["name"] for c in BENCH["configs"]}
