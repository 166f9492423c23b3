"""Fused frame program: the median, over the ``program`` spans that start in
the window, of the summed length of their ``program.face``, ``program.mesh``
and ``program.pose`` children (``runtime/fused.py``): the host's enqueue of
the detectors for one program, in ms. Read from the driver's host spans
``(start, end, name)``; a child belongs to the ``program`` span that holds
it (one program is enqueued at a time)."""

import bisect

from portbench.stats import percentile

DETECTORS = ("program.face", "program.mesh", "program.pose")


def read(rec, metric):
    t0, t1 = rec.window
    programs = sorted((s, e) for s, e, name in rec.out.spans if name == "program" and t0 <= s <= t1)
    children = sorted((s, e) for s, e, name in rec.out.spans if name in DETECTORS)
    if not programs or not children:
        return None
    starts = [s for s, _ in children]
    sums = []
    for s, e in programs:
        i = bisect.bisect_left(starts, s)
        total = 0.0
        while i < len(children) and children[i][0] <= e:
            if children[i][1] <= e:
                total += children[i][1] - children[i][0]
            i += 1
        sums.append(total)
    return percentile(sums, 50) * 1e3
