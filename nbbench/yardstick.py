"""The benchmark's yardstick, frozen here so that a change to the program
cannot move it: the card's peaks, the work a configuration needs, and the
union of a trace's device intervals.

Peaks and FLOP per pair are copies of ``chip_smoke.py``'s ``bound`` table
(``FP32_FLOPS``, ``MUFU_RATE``, ``HBM_BYTES``, ``FLOP``): an H100 SXM at its
1.98 GHz boost clock, 132 SMs x 128 FP32 lanes x 2 = 66.9 TFLOP/s, 132 x 16
MUFU results a clock = 4.18 T rsqrt/s, and 3.35 TB/s of HBM3.  The
interval union is a copy of ``chip_smoke.py::_busy_us``.

:func:`pair_bound_s` counts the work of the configuration and not the work
of any kernel: N(N-1)/2 unordered pairs a force evaluation (Newton's third
law), 25 FP32 FLOP and one rsqrt a pair (``sym_hops``' count), and for a
gradient the VJP's 61 FLOP and one rsqrt a pair more (``vjp_sym_hops``'
count); the state's bytes are read once and written once.  A route that
forms every ordered pair, as the exact one does, reads about half of what
its own kernel's share says: a Newton-3 route may beat it.
"""

from __future__ import annotations

FP32_FLOPS = 132 * 128 * 2 * 1.98e9
MUFU_RATE = 132 * 16 * 1.98e9
HBM_BYTES = 3.35e12

# FP32 FLOP and rsqrts an unordered pair.
FORWARD_PAIR = {"flop": 25, "rsqrt": 1}
VJP_PAIR = {"flop": 61, "rsqrt": 1}
# One step reads and writes pos_mass, vel and accel: 3 x (N, 4) float32.
STATE_BYTES_A_BODY = 3 * 4 * 4


def pair_bound_s(n: int, *, gradient: bool = False) -> dict:
    """The least time one step of ``n`` bodies can take on the card
    (a rollout step of a gradient: forward and VJP), and what binds it."""
    pairs = n * (n - 1) / 2
    flop = pairs * (FORWARD_PAIR["flop"] + (VJP_PAIR["flop"] if gradient else 0))
    rsqrt = pairs * (FORWARD_PAIR["rsqrt"] + (VJP_PAIR["rsqrt"] if gradient else 0))
    nbytes = 2 * n * STATE_BYTES_A_BODY * (2 if gradient else 1)
    times = {"fp32": flop / FP32_FLOPS, "mufu": rsqrt / MUFU_RATE, "hbm": nbytes / HBM_BYTES}
    by = max(times, key=times.get)
    return {"seconds": times[by], "by": by, "pairs": pairs, "flop": flop, "rsqrt": rsqrt, "bytes": nbytes}


def busy_union(spans) -> float:
    """The union of ``(start, end)`` intervals: the time in which the device
    ran at least one operation."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo


def idle_gaps(spans) -> list[tuple[float, float]]:
    """The ``(start, end)`` gaps between the union's intervals."""
    spans = sorted(spans)
    gaps, hi = [], None
    for s, e in spans:
        if hi is not None and s > hi:
            gaps.append((hi, s))
        hi = e if hi is None else max(hi, e)
    return gaps
