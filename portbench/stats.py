"""Window statistics, taken over all the work and all the time of a window.

A rate is every completion inside the window over the window's length. A
percentile is over every request due in the window, each timed from when it
was due to when its result was on the host; a request that failed or never
came counts as infinitely late. Nothing here is a median of chunks or gaps.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between order
    statistics (numpy's default); ``inf`` values sort last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(completions: Iterable[float], t0: float, t1: float) -> float:
    """Completions with a time in [t0, t1], per second of the window."""
    return sum(1 for t in completions if t0 <= t <= t1) / (t1 - t0)


def latencies(due: Sequence[float], done: Sequence[float]) -> list:
    """Each request's time from due to done; ``None`` for done counts as never."""
    return [math.inf if d is None else d - s for s, d in zip(due, done)]

