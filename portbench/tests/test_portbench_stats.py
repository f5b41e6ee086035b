"""Rate, tail and busy-time arithmetic on synthetic timelines."""

import statistics

import pytest

from portbench.core import stats
from portbench.core.reduce import idle, idle_in_bins


def test_rate_counts_a_stall_that_a_median_of_pieces_misses():
    # 100 steps of 10 ms and one stall of 500 ms inside the window
    pieces = [0.010] * 100 + [0.500]
    window = sum(pieces)
    assert stats.rate(100 * 512, window) == pytest.approx(51200 / 1.5)
    median_rate = 512 / statistics.median(pieces)
    assert median_rate > 1.4 * stats.rate(100 * 512, window)


def test_open_loop_tail_counts_the_bins_queued_behind_a_stall():
    period, work = 0.005, 0.001
    due = [k * period for k in range(1000)]
    free, lat = 0.0, []
    for k, d in enumerate(due):
        start = max(d, free)
        if k == 500:
            start += 0.100  # a 100 ms stall
        free = start + work
        lat.append(free - d)
    # a median of per-bin work would read 1 ms; the tail sees the queue
    assert stats.tail(lat, 0.99) > 0.030
    assert stats.tail(lat, 0.5) == pytest.approx(work)


def test_tail_is_nearest_rank():
    vals = list(range(1, 101))
    assert stats.tail(vals, 0.99) == 99
    assert stats.tail(vals, 1.0) == 100
    assert stats.tail([5.0], 0.99) == 5.0


def test_union_of_overlapping_operations():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.covered(ivs, 0.0, 5.0) == pytest.approx(3.0)
    assert stats.covered(ivs, 1.5, 3.5) == pytest.approx(1.0)
    assert stats.gaps(ivs, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_idle_shares_from_a_record():
    dev = [("k", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)]
    rec = {"kind": "train", "device": dev, "busy_s": 3.0, "window_s": 4.0}
    assert idle(rec, "train") == pytest.approx(25.0)
    assert idle(rec, "eval") is None
    srec = {"kind": "stream", "device": dev, "bins": [(0.0, 2.0),
                                                     (2.0, 4.0)]}
    # the gap between bins (2, 3) counts; what lies outside bins would not
    assert idle_in_bins(srec) == pytest.approx(25.0)
