"""``dispatch_ms`` (step): host milliseconds a step inside the program's
``nbody3d.step`` spans (one a step of ``make_step_fn``, any route; under
autograd the forward's host work) in the profiled stretch.  None where the
program opens no such span."""


def read(rec):
    spans = [e - s for n, s, e in rec["host_events"] if n == "nbody3d.step"]
    if not spans or not rec["steps"]:
        return None
    return sum(spans) * 1e-3 / rec["steps"]
