"""Serving: the 95th percentile of the ``server.queue`` spans that end in
the window, each request's wait from its submit to the dispatcher taking it
(``runtime/server.py``), in ms."""

from portbench import spans
from portbench.stats import percentile


def read(rec, metric):
    recorded = spans.of(rec)
    if not recorded:
        return None
    t0, t1 = rec.window
    waits = [s.end - s.start for s in spans.named(recorded, "server.queue") if t0 <= s.end <= t1]
    return percentile(waits, 95) * 1e3 if waits else None
