"""The end-to-end metrics' arithmetic on synthetic call times."""

from __future__ import annotations

import statistics

import pytest

import run
from benchlib import stats


def test_percentile_interpolates_like_numpy():
    values = [float(v) for v in range(1, 101)]
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.percentile(values, 50) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3.0, 1.0, 2.0], 100) == 3.0


def test_stall_moves_the_tail():
    """Twenty calls stalled at 250 ms in a window of 400 calls at 50 ms
    move the 95th percentile; the median does not see them."""
    steady = [50.0] * 400
    stalled = [50.0] * 380 + [250.0] * 20
    assert stats.percentile(steady, 95) == 50.0
    assert stats.percentile(stalled, 95) > 50.0
    assert statistics.median(stalled) == 50.0


def test_rate_takes_all_work_over_all_time():
    out = dict(body_substeps=60 * 8192 * 2 * 400, window_s=20.0,
               call_ms=[50.0] * 400, setup_s=12.5)
    e2e = run.end_to_end(out)
    assert e2e["body_steps_per_s"] == pytest.approx(60 * 8192 * 2 * 400 / 20)
    assert e2e["call_ms_p95"] == 50.0
    assert e2e["setup_s"] == 12.5
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / med)


def test_traced_calls_bounds():
    assert run.traced_calls(0.05) == 6
    assert run.traced_calls(1.0) == 4
    assert run.traced_calls(0.001) == 32
