"""Whole step: the network's operations a frame (``roofline.network_flops``)
times the frames completed in the window, over the chip's peak for the
configuration's type (TF32's dense rate for float32), in %.

``mfu.fps`` divides by the window's length: the share of the peak that the
stream's throughput uses. ``mfu.lat`` divides by the device's busy time in
the window: the share of the peak while the program runs, which an
open-loop cell's offered load does not fix."""

from portbench import roofline, trace


def read(rec, metric):
    peak = roofline.peaks(rec.device_name)
    n = rec.completed_in_window()
    if peak is None or not n:
        return None
    t0, t1 = rec.window
    if metric["moves"] == "frames_per_s":
        seconds = t1 - t0
    else:
        events = rec.events()
        if not events:
            return None
        seconds = sum(e - s for s, e in trace.busy_intervals(events, t0, t1))
    rate = peak["matmul_flops_per_s"][rec.run.config["dtype"]]
    return 100.0 * rec.flops_per_frame() * n / seconds / rate
