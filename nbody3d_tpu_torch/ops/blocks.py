"""Tile-size resolution shared by the plain chunked paths."""

from __future__ import annotations


def divisor_block(n: int, want: int, floor: int = 8) -> int:
    """Largest block <= ``want`` that divides ``n``: halve while above
    ``floor``, then decrement to the nearest divisor."""
    if n <= 0:
        raise ValueError(f"cannot fit a block into n={n}")
    b = max(1, min(want, n))
    while b > floor and n % b != 0:
        b //= 2
    while n % b != 0:
        b -= 1
    return b
