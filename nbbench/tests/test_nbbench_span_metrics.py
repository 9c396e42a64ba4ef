"""The readers of the program's spans (``nbody3d.*``) on records made by
hand: each gives its exact value, and None on a record without the
program's spans (a program that opens none)."""

import pytest

from nbbench import harness

SPAN_READERS = ("resort_ms.step", "dispatch_ms.step", "boundary_idle_ms.step", "syncs_per_step.step",
                "dispatch_ms.grad", "vjp_host_ms.grad", "syncs_per_step.grad")


def _read(name, rec):
    return harness.metric_reader(name)(rec)


def _step_record():
    """Two chunks of two steps, the second after a re-sort; times in us."""
    host = [
        ("nbody3d.step", 100.0, 110.0), ("nbody3d.step", 120.0, 130.0),
        ("nbody3d.engine.wait", 140.0, 300.0), ("cudaEventSynchronize", 150.0, 290.0),
        ("nbody3d.engine.resort", 310.0, 340.0), ("aten::sort", 312.0, 330.0),
        ("nbody3d.step", 350.0, 360.0), ("nbody3d.step", 370.0, 380.0),
        ("cudaStreamSynchronize", 372.0, 375.0),  # an .item() inside a step
        ("nbody3d.engine.wait", 390.0, 500.0), ("cudaEventSynchronize", 395.0, 495.0),
        ("cudaEventSynchronize", 600.0, 650.0),  # the benchmark's own wait
    ]
    device = [("force", 112.0, 250.0), ("sort", 320.0, 330.0), ("force", 362.0, 470.0)]
    return {"host_events": host, "device_events": device, "steps": 4, "units": 2}


def _grad_record():
    """One gradient of a 5-step rollout: 5 step spans, 4 VJP spans."""
    host = [("nbody3d.step", 20.0 * i, 20.0 * i + 20.0) for i in range(5)]
    host += [("nbody3d.vjp", 200.0 + 40.0 * i, 230.0 + 40.0 * i) for i in range(4)]
    host += [("cudaLaunchKernel", 205.0, 210.0), ("cudaEventSynchronize", 400.0, 420.0)]
    return {"host_events": host, "device_events": [("vjp", 210.0, 380.0)], "steps": 5, "units": 1}


def test_step_readers():
    rec = _step_record()
    assert _read("resort_ms.step", rec) == pytest.approx(30e-3 / 4)
    assert _read("dispatch_ms.step", rec) == pytest.approx(40e-3 / 4)
    # One boundary (the last wait has no next chunk): from the wait's end
    # (300) to the next chunk's first device op (362), less the sort's 10.
    assert _read("boundary_idle_ms.step", rec) == pytest.approx(52e-3)
    # The two waits and the .item(); the benchmark's own wait is outside.
    assert _read("syncs_per_step.step", rec) == pytest.approx(3 / 4)


def test_boundary_idle_subtracts_device_ops_inside_the_boundary():
    rec = _step_record()
    rec["device_events"] = [e for e in rec["device_events"] if e[0] != "sort"]
    assert _read("boundary_idle_ms.step", rec) == pytest.approx(62e-3)
    rec["device_events"].append(("copy", 290.0, 305.0))  # begins before the wait's end
    assert _read("boundary_idle_ms.step", rec) == pytest.approx(57e-3)


def test_grad_readers():
    rec = _grad_record()
    assert _read("dispatch_ms.grad", rec) == pytest.approx(100e-3 / 5)
    assert _read("vjp_host_ms.grad", rec) == pytest.approx(120e-3 / 5)
    assert _read("syncs_per_step.grad", rec) == 0.0


def test_syncs_ignore_a_wait_outside_every_program_span():
    rec = _grad_record()
    rec["host_events"].append(("cudaEventSynchronize", 215.0, 225.0))  # inside a VJP span
    assert _read("syncs_per_step.grad", rec) == pytest.approx(1 / 5)


@pytest.mark.parametrize("name", SPAN_READERS)
@pytest.mark.parametrize("make", [_step_record, _grad_record], ids=["step", "grad"])
def test_none_without_program_spans(name, make):
    rec = make()
    rec["host_events"] = [e for e in rec["host_events"] if not e[0].startswith("nbody3d.")]
    assert _read(name, rec) is None


def test_resort_none_where_nothing_sorts():
    assert _read("resort_ms.step", _grad_record()) is None
    assert _read("boundary_idle_ms.step", _grad_record()) is None
