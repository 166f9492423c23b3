"""Window statistics: a rate is all completions over all the window, a
percentile is over every request, and a stall inside the window moves both."""

import math

import numpy as np
import pytest

from portbench.stats import latencies, percentile, rate


def test_percentile_is_numpys_linear_interpolation():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=937).tolist()
    for q in (0, 5, 50, 95, 99, 100):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_a_missing_request_counts_as_infinitely_late():
    lat = latencies([0.0, 1.0, 2.0, 3.0], [0.1, 1.1, None, 3.1])
    assert lat[2] == math.inf
    assert percentile(lat, 100) == math.inf
    assert percentile(lat, 50) == pytest.approx(0.1)


def test_rate_counts_every_completion_over_the_whole_window():
    done = [0.5 + 0.01 * i for i in range(100)] + [11.0]  # the last one lands after the window
    assert rate(done, 0.0, 10.0) == pytest.approx(10.0)


def test_a_stall_moves_the_rate_and_the_tail():
    # closed loop: a frame completes every 10 ms, except for a 1.2-s stall
    steady = [0.01 * (i + 1) for i in range(1000)]
    stalled = [t + (1.2 if t > 4.0 else 0.0) for t in steady]
    assert rate(stalled, 0.0, 10.0) == pytest.approx(rate(steady, 0.0, 10.0) - 120.0 / 10.0)
    # a median of chunks of gaps would not see it: most chunks are untouched
    chunks = [np.median(np.diff(stalled[i:i + 100])) for i in range(0, 1000, 100)]
    assert np.median(chunks) == pytest.approx(0.01)
    # open loop: what is due during the stall waits for its end
    due = [0.01 * i for i in range(1000)]
    done = [d + 0.02 for d in due]
    held = [max(d, 9.6) + 0.02 if d >= 8.4 else d + 0.02 for d in due]
    assert percentile(latencies(due, held), 95) > 10 * percentile(latencies(due, done), 95)

