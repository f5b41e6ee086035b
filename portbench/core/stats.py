"""Rates, tails and interval arithmetic.

Every end-to-end number is taken over all the work and all the time of a
window, never from medians of pieces: a stall inside the window moves it.
"""

from __future__ import annotations

import bisect
import math


def rate(units: float, seconds: float) -> float:
    """Units completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return units / seconds


def tail(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by nearest rank over every value: the
    smallest value with at least a share q of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    k = max(1, math.ceil(q * len(vals)))
    return vals[k - 1]


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the union of ``intervals`` covers."""
    return Union(intervals).covered(lo, hi)


class Union:
    """The union of intervals, merged once, for many windows."""

    def __init__(self, intervals):
        self.spans = merge(intervals)
        self.starts = [s for s, _ in self.spans]

    def covered(self, lo: float, hi: float) -> float:
        total = 0.0
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        for s, e in self.spans[i:]:
            if s >= hi:
                break
            s, e = max(s, lo), min(e, hi)
            if e > s:
                total += e - s
        return total


def gaps(intervals, lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers."""
    out = []
    cur = lo
    for s, e in merge(intervals):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out
