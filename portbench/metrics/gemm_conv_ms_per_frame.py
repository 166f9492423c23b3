"""Dense layers: device time of cuBLAS GEMMs and cuDNN convolutions in the
window (kernels classed by name, ``portbench/kernels.py``), in ms per frame
completed in the window."""

from portbench import kernels, trace


def read(rec, metric):
    events, n = rec.events(), rec.completed_in_window()
    if not events or not n:
        return None
    t0, t1 = rec.window
    dense = [e - s for name, s, e in trace.clip(events, t0, t1) if kernels.is_dense(name)]
    return sum(dense) / n * 1e3 if dense else None
