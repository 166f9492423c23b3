"""The program's own spans in a traced window, and the device's idle gaps
named by them.

The program records spans where its work happens (``runtime/tracing.py``:
``server.*`` in the batcher, ``stream.*`` in ``VidStream``, ``program*`` in
the frame program) when a run enters ``tracing.record()``; a run that does
so keeps them on the record as ``program_spans``. Each span has ``name``,
``start``, ``end`` (``time.perf_counter()`` seconds, the clock the device
trace's events are mapped onto), ``span_id``, ``parent_id``, ``thread_id``
and ``ids`` (``req``, ``batch``, ``frame``, ``rows``). A record without
them gives None to every reader here.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import trace


def of(rec) -> Optional[list]:
    """The run's program spans, or None where the run recorded none."""
    return getattr(rec, "program_spans", None) or None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def starting_in(spans, t0: float, t1: float) -> list:
    return [s for s in spans if t0 <= s.start <= t1]


def _sweep(gaps: Sequence[Tuple[float, float]], intervals):
    """For each gap, in order of start, its index and the intervals
    ``(start, end, payload)`` that overlap it: one sweep over both sorted."""
    ivs = sorted(intervals, key=lambda iv: iv[0])
    active: list = []
    j = 0
    for i in sorted(range(len(gaps)), key=lambda i: gaps[i][0]):
        g0, g1 = gaps[i]
        while j < len(ivs) and ivs[j][0] < g1:
            active.append(ivs[j])
            j += 1
        active = [iv for iv in active if iv[1] > g0]  # the gaps come in order: one ended is done
        yield i, active


def _pieces(gaps, program_spans, driver_spans, default: str) -> List[Dict[str, float]]:
    """Each gap cut where a span starts or ends, each piece given to the
    innermost program span over it: the shortest, of any thread, with a span
    emitted after the fact (one that begins before its parent, as a
    request's queue wait does) only where no other covers the piece. A piece
    that no program span covers goes to the driver's span over it (the
    first to start), else to ``default``. Per gap: seconds by label."""
    by_id = {s.span_id: s for s in program_spans or ()}

    def rank(s):  # what wins a piece: a span of the program's own flow, then the shortest
        parent = by_id.get(s.parent_id)
        return (parent is not None and s.start < parent.start, s.end - s.start)

    prog = list(_sweep(gaps, [(s.start, s.end, s.name, rank(s)) for s in program_spans or ()]))
    drv = dict(_sweep(gaps, driver_spans))
    out: List[Dict[str, float]] = [{} for _ in gaps]
    for i, active in prog:
        g0, g1 = gaps[i]
        both = active + drv[i]
        cuts = sorted({g0, g1, *(t for iv in both for t in iv[:2] if g0 < t < g1)})
        by_label: Dict[str, float] = defaultdict(float)
        for a, b in zip(cuts, cuts[1:]):
            over = [iv for iv in active if iv[0] <= a and iv[1] >= b]
            if over:
                label = min(over, key=lambda iv: iv[3])[2]
            else:
                label = next((iv[2] for iv in drv[i] if iv[0] <= a and iv[1] >= b), default)
            by_label[label] += b - a
        out[i] = dict(by_label)
    return out


def breakdown(events, program_spans, driver_spans, t0: float, t1: float, default: str, top: int = 10) -> Dict:
    """``trace.breakdown`` with the idle time named by the program's spans
    (``_pieces``): each of the longest gaps by the label that holds most of
    it, and ``idle_by_span``, the window's idle seconds summed by label over
    every gap."""
    out = trace.breakdown(events, driver_spans, t0, t1, default, top)
    gaps = trace.idle_gaps(trace.busy_intervals(events, t0, t1), t0, t1)
    pieces = _pieces(gaps, program_spans, driver_spans, default)
    idle: Dict[str, float] = defaultdict(float)
    for by_label in pieces:
        for label, sec in by_label.items():
            idle[label] += sec
    longest = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])[:top]
    out["idle_gaps"] = [[f"{max(pieces[i].items(), key=lambda kv: kv[1])[0]} @ {gaps[i][0] - t0:.3f}s",
                         gaps[i][1] - gaps[i][0]] for i in longest]
    out["idle_by_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    return out
