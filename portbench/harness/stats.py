"""The benchmark's arithmetic: percentiles, rates, and what a device
timeline says (busy time as the union of intervals, idle gaps).  Pure
Python, so the tests check it on synthetic records."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)), 1) - 1]


def rate(count: float, seconds: float) -> float:
    """All the work over all the time of the window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def merged(intervals: Iterable[Interval], lo: float = -math.inf, hi: float = math.inf) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], as disjoint sorted
    intervals."""
    out: List[Interval] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def covered(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by at least one interval (overlaps once)."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers, longest first."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])

