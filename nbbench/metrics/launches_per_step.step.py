"""``launches_per_step`` (step): every device operation in the profiled
stretch (the port's kernels, torch's kernels, copies and fills) over the
steps it holds.  The port's own registry count is printed on an earlier
line."""


def read(rec):
    if not rec["device_events"] or not rec["steps"]:
        return None
    return len(rec["device_events"]) / rec["steps"]
