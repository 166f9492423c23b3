"""Arrival schedules, and latency taken from the due time."""

import numpy as np
import pytest

from portbench import schedule
from portbench.stats import latencies


def test_poisson_every_seed_gets_the_same_gaps_in_another_order():
    spec = {"process": "poisson", "rate_per_s": 40.0}
    a = schedule.arrivals(spec, 20.0, 1)
    b = schedule.arrivals(spec, 20.0, 3_000_000_017)
    assert len(a) == len(b) == 800
    ga, gb = np.diff(a + [20.0]), np.diff(b + [20.0])
    assert sorted(ga) == pytest.approx(sorted(gb), rel=1e-12)
    assert not np.allclose(ga, gb)
    assert a[0] == 0.0 and max(a) < 20.0 and all(x < y for x, y in zip(a, a[1:]))
    assert ga.sum() == pytest.approx(20.0)
    assert schedule.arrivals(spec, 20.0, 1) == a  # the same seed, the same schedule


def test_poisson_gaps_are_exponential():
    gaps = np.diff(schedule.arrivals({"process": "poisson", "rate_per_s": 50.0}, 40.0, 5))
    assert np.mean(gaps) == pytest.approx(1 / 50.0, rel=0.01)
    assert np.std(gaps) == pytest.approx(1 / 50.0, rel=0.1)  # an exponential's sd is its mean


def test_paced_is_one_frame_every_period():
    a = schedule.arrivals({"process": "paced", "rate_per_s": 30.0}, 20.0, 9)
    assert len(a) == 600
    assert np.diff(a) == pytest.approx(np.full(599, 1 / 30.0))


def test_closed_has_no_schedule():
    assert schedule.arrivals({"process": "closed"}, 20.0, 1) is None


def test_latency_is_taken_from_the_due_time():
    due = schedule.arrivals({"process": "paced", "rate_per_s": 30.0}, 1.0, 1)
    sent = [d + 0.005 for d in due]  # the generator ran 5 ms late
    done = [s + 0.010 for s in sent]
    assert latencies(due, done) == pytest.approx([0.015] * len(due))
