"""The arithmetic of the end-to-end metrics, on plain lists of numbers."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear interpolation
    between the closest ranks, as ``numpy.percentile`` computes it by
    default. Every value counts: a stall is part of the tail."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside 0..100")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work done over the wall seconds it took."""
    if seconds <= 0.0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def spread(values) -> float:
    """The distance between the first and the third quartile, as
    ``statistics.quantiles(values, n=4)`` gives them, as a share of the
    median: the spread the benchmark's bounds are set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
