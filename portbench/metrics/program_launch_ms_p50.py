"""Frame program: the median duration of the ``program`` spans that start
in the window (``estimator.py``: the upload, K2, the network and K3 as the
host enqueues them; the device's time is the trace's), in ms."""

from portbench import spans
from portbench.stats import percentile


def read(rec, metric):
    recorded = spans.of(rec)
    if not recorded:
        return None
    t0, t1 = rec.window
    launches = [s.end - s.start for s in spans.starting_in(spans.named(recorded, "program"), t0, t1)]
    return percentile(launches, 50) * 1e3 if launches else None
