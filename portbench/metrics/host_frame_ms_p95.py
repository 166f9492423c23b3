"""Fused stream: the 95th percentile of the ``stream.host_frame`` spans that
start in the window (``FusedVidStream``: a frame's face state, depth sample,
route, HUD and side-by-side write after its tick's fetch), in ms."""

from portbench.stats import percentile


def read(rec, metric):
    t0, t1 = rec.window
    frames = [e - s for s, e, name in rec.out.spans if name == "stream.host_frame" and t0 <= s <= t1]
    return percentile(frames, 95) * 1e3 if frames else None
