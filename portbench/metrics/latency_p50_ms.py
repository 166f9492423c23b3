"""Median latency over every request or frame due in the window, each from
its due time to its map on the host (a missing one counts as never)."""

from portbench.stats import percentile


def read(rec, metric):
    if rec.out.due is None:
        return None
    return percentile(rec.latencies(), 50) * 1e3
