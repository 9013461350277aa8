"""Shape bucketing (copied from fwav_tpu/utils/buckets.py).

The port keeps the JAX package's buckets so that both packages pad the
same ranges and bank rows, take the same search branch and emit the same
sentinels."""

from __future__ import annotations


def bucket(n: int, minimum: int = 256) -> int:
    """Smallest value >= max(n, 1) from the grid {4, 5, 6, 7} * (minimum/4)
    * 2^k with m = `minimum` (a power of two >= 4)."""
    if n <= minimum:
        return minimum
    b = minimum
    while True:
        for num in (5, 6, 7):
            c = (b // 4) * num
            if c >= n:
                return c
        b *= 2
        if b >= n:
            return b


def pad_to(n: int, multiple: int) -> int:
    """Round up to a multiple."""
    return ((n + multiple - 1) // multiple) * multiple
