"""Fused stream: the share of the ``stream.host_frame`` spans that start in
the window holding a ``stream.iris_path`` span, in %: the frames that took
the iris route (a face found, its iris fit not degenerate) rather than the
body route (``FusedVidStream._route_frame``)."""

import bisect


def read(rec, metric):
    t0, t1 = rec.window
    frames = sorted((s, e) for s, e, name in rec.out.spans if name == "stream.host_frame" and t0 <= s <= t1)
    if not frames:
        return None
    starts = [s for s, _ in frames]
    iris = 0
    for s, e, name in rec.out.spans:
        if name == "stream.iris_path":
            i = bisect.bisect_right(starts, s) - 1
            iris += i >= 0 and e <= frames[i][1]
    return 100.0 * iris / len(frames)
