"""95th percentile of the latencies of every request or frame due in the
window, each from its due time to its map on the host."""

from portbench.stats import percentile


def read(rec, metric):
    if rec.out.due is None:
        return None
    return percentile(rec.latencies(), 95) * 1e3
