"""``resort_ms.step`` (engine): host milliseconds a step inside the
program's ``nbody3d.engine.resort`` spans (the Morton re-sort at a chunk's
start) in the profiled stretch.  None where the program opens no such
span."""


def read(rec):
    spans = [e - s for n, s, e in rec["host_events"] if n == "nbody3d.engine.resort"]
    if not spans or not rec["steps"]:
        return None
    return sum(spans) * 1e-3 / rec["steps"]
