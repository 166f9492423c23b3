"""Serving: the median, over consecutive batches dispatched in the window,
of batch k+1's ``program.k2`` start less batch k's ``server.fetch`` end: the
dispatcher's serial work (results, the next collect, pad and upload) while
the device has nothing of its own, in ms."""

from portbench import spans
from portbench.stats import percentile


def read(rec, metric):
    recorded = spans.of(rec)
    if not recorded:
        return None
    t0, t1 = rec.window
    by_id = {s.span_id: s for s in recorded}

    def batch_of(s):
        while s is not None and s.name != "server.dispatch":
            s = by_id.get(s.parent_id)
        return None if s is None else s.ids["batch"]

    fetch_end = {batch_of(s): s.end for s in spans.named(recorded, "server.fetch")}
    k2_start = {batch_of(s): s.start for s in spans.named(recorded, "program.k2")}
    batches = sorted(s.ids["batch"] for s in spans.starting_in(spans.named(recorded, "server.dispatch"), t0, t1))
    gaps = [k2_start[b] - fetch_end[a] for a, b in zip(batches, batches[1:]) if a in fetch_end and b in k2_start]
    return percentile(gaps, 50) * 1e3 if gaps else None
