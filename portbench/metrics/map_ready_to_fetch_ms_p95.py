"""Stream: how long a finished map sat in pinned memory before the loop
came for it. For each ``stream.fetch`` span that starts in the window: its
start less the end of the latest device-to-host copy of the device trace
that ends no later than the span's end, floored at 0; the 95th percentile,
in ms."""

import bisect

from portbench import spans
from portbench.stats import percentile


def read(rec, metric):
    recorded, events = spans.of(rec), rec.events()
    if not recorded or not events:
        return None
    t0, t1 = rec.window
    copied = sorted(e for name, _, e in events if "DtoH" in name)
    waits = []
    for s in spans.starting_in(spans.named(recorded, "stream.fetch"), t0, t1):
        k = bisect.bisect_right(copied, s.end)
        if k:
            waits.append(max(0.0, s.start - copied[k - 1]))
    return percentile(waits, 95) * 1e3 if waits else None
