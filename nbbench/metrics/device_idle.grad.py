"""``device_idle`` (device), in %: 1 - (union of the device operations'
intervals) / (the profiled stretch's wall time)."""


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
