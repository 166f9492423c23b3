"""Serving: requests served over the rows dispatched (``frames_served`` over
``batches_dispatched`` x ``max_batch`` of the window's dispatches), in %."""


def read(rec, metric):
    s = rec.out.server
    if not s or not s["batches"]:
        return None
    return 100.0 * s["frames"] / (s["batches"] * s["max_batch"])
