"""``pair_roofline`` (kernels), in %: the configuration's least time a step
(``yardstick.pair_bound_s``: N(N-1)/2 pairs at 25 FP32 FLOP, and 61 more
for a gradient's VJP) over the device's busy time a step in the profiled
stretch."""


def read(rec):
    if rec["busy_s"] <= 0 or not rec["steps"]:
        return None
    return 100.0 * rec["pair_bound_s"] / (rec["busy_s"] / rec["steps"])
