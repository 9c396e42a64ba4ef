"""The frozen yardstick: the pair counts of the configurations, the peaks,
the interval union, and the per-layer readers on a record made by hand."""

import math

import pytest

from nbbench import harness, yardstick


def test_peaks_are_the_h100_sxm_at_its_boost_clock():
    assert yardstick.FP32_FLOPS == pytest.approx(66.9e12, rel=1e-3)
    assert yardstick.MUFU_RATE == pytest.approx(4.18e12, rel=1e-3)
    assert yardstick.HBM_BYTES == 3.35e12


@pytest.mark.parametrize("n, gradient, ms", [
    (40002, False, 0.298940), (262144, False, 12.83835), (40002, True, 1.028352),
])
def test_pair_bound_counts_unordered_pairs(n, gradient, ms):
    b = yardstick.pair_bound_s(n, gradient=gradient)
    assert b["pairs"] == n * (n - 1) / 2
    assert b["flop"] == b["pairs"] * (86 if gradient else 25)
    assert b["by"] == "fp32"
    assert b["seconds"] * 1e3 == pytest.approx(ms, rel=1e-4)
    assert b["rsqrt"] / yardstick.MUFU_RATE < b["seconds"]


def test_busy_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 11)]
    assert yardstick.busy_union(spans) == 6
    assert yardstick.idle_gaps(spans) == [(3, 5), (7, 10)]
    assert yardstick.busy_union([]) == 0.0


def _record(**kw):
    rec = {"device_events": [("k", 0.0, 800.0), ("k", 900.0, 1700.0), ("copy", 1700.0, 1800.0)],
           "host_events": [("aten::add", 850.0, 880.0), ("cudaEventSynchronize", 780.0, 950.0)],
           "busy_s": 1.7e-3, "window_s": 2.0e-3, "steps": 4, "units": 2, "pair_bound_s": 2.0e-4,
           "spans": {"enqueue_s": [0.002, 0.004], "chunk_steps": 2, "backward_s": [0.01], "rollout": 5}}
    rec.update(kw)
    return rec


def test_readers_on_a_record():
    rec = _record()
    read = {name: harness.metric_reader(name)(rec) for name in (
        "pair_roofline.step", "device_idle.step", "launches_per_step.step", "enqueue_ms.step",
        "backward_ms.grad", "pair_roofline.grad", "device_idle.grad", "launches_per_step.grad")}
    assert read["pair_roofline.step"] == pytest.approx(100 * 2.0e-4 / (1.7e-3 / 4))
    assert read["device_idle.step"] == pytest.approx(15.0)
    assert read["launches_per_step.step"] == 0.75
    assert read["enqueue_ms.step"] == pytest.approx(1.5)
    assert read["backward_ms.grad"] == pytest.approx(2.0)
    assert read["pair_roofline.grad"] == read["pair_roofline.step"]


def test_readers_find_nothing_to_read():
    rec = _record(device_events=[], busy_s=0.0, spans={})
    for name in ("pair_roofline.step", "device_idle.grad", "launches_per_step.step", "enqueue_ms.step",
                 "backward_ms.grad"):
        assert harness.metric_reader(name)(rec) is None


def test_breakdown_names_gaps_by_the_innermost_host_op():
    b = harness.breakdown(_record())
    assert b["device_ops"][0][0] == "k" and b["device_ops"][0][1] == pytest.approx(1.6e-3)
    assert b["idle_gaps"] == [["aten::add", pytest.approx(1e-4)]]


def test_judge_holds_each_number_to_its_limit():
    ok, checks = harness.judge({"a": 1.0, "b": 0.0}, {"a": 2.0, "b": 0.0})
    assert ok and checks["a"] == {"value": 1.0, "limit": 2.0}
    assert not harness.judge({"a": math.nan}, {"a": 1.0})[0]
    assert not harness.judge({"a": 3.0}, {"a": 2.0})[0]
    assert not harness.judge({}, {"a": 2.0})[0]
