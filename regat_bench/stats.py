"""The arithmetic of the benchmark's numbers: percentiles over all requests,
quartile spreads, unions of device intervals and idle gaps, rates."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it. A failed request enters
    as +inf, so it counts as the slowest."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median, as a share: Python's
    statistics.quantiles(values, n=4) (the 'exclusive' method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def rate(count: float, seconds: float) -> float:
    """Work per second; a window of no length has none."""
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return count / seconds


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi)."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def idle_share(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """1 - busy / (hi - lo): the share of the window in which no interval
    (device operation) runs. Overlapping operations count once."""
    if hi <= lo:
        raise ValueError("an empty window")
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle stretches of [lo, hi) between the merged intervals."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def top(totals: Dict[str, float], k: int = 10) -> List[List]:
    """The k largest (name, value) pairs, largest first."""
    return [[n, v] for n, v in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]
