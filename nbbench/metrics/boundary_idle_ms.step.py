"""``boundary_idle_ms.step`` (engine): the device's idle milliseconds at a
chunk boundary.  For each ``nbody3d.engine.wait`` span of the program
that a next chunk follows in the profiled stretch: from the wait's end to
the start of the first device operation that begins after the next
``nbody3d.step`` span starts, less the device's busy time inside that
interval (the re-sort's own operations); the mean over those boundaries.
None where the program opens no such spans."""

import bisect

from nbbench.yardstick import busy_union


def read(rec):
    host = rec["host_events"]
    waits = sorted(e for n, s, e in host if n == "nbody3d.engine.wait")
    steps = sorted(s for n, s, e in host if n == "nbody3d.step")
    device = sorted((s, e) for _, s, e in rec["device_events"])
    starts = [s for s, _ in device]
    idle = []
    for lo in waits:
        i = bisect.bisect_left(steps, lo)
        if i == len(steps):
            continue
        j = bisect.bisect_left(starts, steps[i])
        if j == len(starts):
            continue
        hi = starts[j]
        inside = [(max(s, lo), min(e, hi)) for s, e in device[:j] if e > lo]
        idle.append(hi - lo - busy_union(inside))
    if not idle:
        return None
    return sum(idle) / len(idle) * 1e-3
