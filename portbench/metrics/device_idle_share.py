"""Device: the share of the window in which no kernel or copy ran, in %."""

from portbench import trace


def read(rec, metric):
    events = rec.events()
    if not events:
        return None
    t0, t1 = rec.window
    return 100.0 * (1.0 - sum(e - s for s, e in trace.busy_intervals(events, t0, t1)) / (t1 - t0))
