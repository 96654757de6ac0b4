"""Percentiles over all requests, spreads, the union-of-intervals idle
share and its gaps, rates."""

import math
import statistics

import pytest

from regat_bench import stats


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, math.inf, 4], 95) == math.inf
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_uses_python_quartiles():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, m, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / m)


def test_union_counts_overlaps_once():
    iv = [(0, 10), (5, 15), (20, 30)]
    assert stats.merge(iv) == [(0, 15), (20, 30)]
    assert stats.busy(iv, 0, 40) == 25
    assert stats.idle_share(iv, 0, 40) == pytest.approx(15 / 40)
    assert stats.busy(iv, 8, 22) == 9
    assert stats.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert stats.gaps(iv, -5, 12) == [(-5, 0)]


def test_idle_share_of_summed_times_would_overcount():
    iv = [(0, 10), (0, 10)]  # two operations side by side on one card
    assert stats.idle_share(iv, 0, 10) == 0.0


def test_rate_and_top():
    assert stats.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)
    assert stats.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]
