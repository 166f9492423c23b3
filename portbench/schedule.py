"""Arrival schedules: when each request or frame of a window is due.

A traffic file's ``arrivals`` names a process:

* ``closed``: no schedule; the next frame is read as soon as the loop asks;
* ``paced``: one arrival every ``1 / rate_per_s`` seconds (a camera);
* ``poisson``: open-loop arrivals at ``rate_per_s``. Every seed gets the same
  set of gaps, the quantiles of the exponential distribution at
  (k + 0.5) / n, scaled to fill the window exactly, in an order shuffled by
  the seed. So every seed sends the same number of requests at the same mean
  rate, and only the order of the gaps, and with it the bursts, changes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np


def arrivals(spec: Dict, seconds: float, seed: int) -> Optional[List[float]]:
    """Due times in seconds from the window's start, ascending, all in
    [0, seconds); None for a closed loop."""
    process = spec["process"]
    if process == "closed":
        return None
    rate = float(spec["rate_per_s"])
    n = int(round(rate * seconds))
    if process == "paced":
        return [k / rate for k in range(n)]
    if process == "poisson":
        rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
        gaps = np.array([-math.log(1.0 - (k + 0.5) / n) for k in range(n)])
        gaps = rng.permutation(gaps) * (seconds / gaps.sum())
        return np.concatenate([[0.0], np.cumsum(gaps[:-1])]).tolist()
    raise ValueError(f"unknown arrival process {process!r}")
