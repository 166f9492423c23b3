"""Device: the union of the window's device activity (kernels, copies),
in ms per frame completed in the window."""

from portbench import trace


def read(rec, metric):
    events, n = rec.events(), rec.completed_in_window()
    if not events or not n:
        return None
    t0, t1 = rec.window
    return sum(e - s for s, e in trace.busy_intervals(events, t0, t1)) / n * 1e3
