"""The device's side of a traced window, from torch.profiler (CUPTI).

Only device activity is recorded (kernels, copies, sets): host operators
would add millions of events to a window of tens of seconds. The profiler
starts before the window and stops after the work is drained, so nothing
is dropped at its edges (it keeps only activity whose mapped times fall
inside its capture), and every event is clipped to the window. Host times
(``time.perf_counter``) are mapped onto the trace's clock by a marker: a
spin kernel launched on an idle device at a known host time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

MARGIN_S = 0.1
MARKER = "spin_kernel"


def _ns(event, what: str) -> int:
    f = getattr(event, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(event, f"{what}_us")()) * 1000


class DeviceTrace:
    def __init__(self):
        self.events: List[Tuple[str, float, float]] = []  # (name, start, end) in perf_counter seconds
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        time.sleep(MARGIN_S)
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.01)

    def stop(self) -> None:
        import torch
        from torch._C._autograd import DeviceType

        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        self._prof.stop()
        raw = [(e.name(), _ns(e, "start"), _ns(e, "duration")) for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        self._prof = None
        marks = [s for name, s, _ in raw if MARKER in name]
        if marks:
            offset_ns = min(marks) - int(self._marker_host * 1e9)
        else:  # the trace's clock is the wall clock's
            offset_ns = time.time_ns() - time.perf_counter_ns()
        self.events = sorted(((name, (s - offset_ns) / 1e9, (s + d - offset_ns) / 1e9) for name, s, d in raw
                              if MARKER not in name), key=lambda e: e[1])


def clip(events: Sequence[Tuple[str, float, float]], t0: float, t1: float):
    """Events overlapping [t0, t1], cut to it."""
    return [(n, max(s, t0), min(e, t1)) for n, s, e in events if e > t0 and s < t1]


def busy_intervals(events, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The union of the events' intervals inside [t0, t1]."""
    out: List[List[float]] = []
    for _, s, e in sorted(clip(events, t0, t1), key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: Sequence[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def by_name(events) -> Dict[str, float]:
    total: Dict[str, float] = defaultdict(float)
    for n, s, e in events:
        total[n] += e - s
    return dict(total)


def whole_inside(events, t0: float, t1: float, match) -> List[Tuple[str, float, float]]:
    """Events wholly inside [t0, t1] whose name ``match`` accepts."""
    return [ev for ev in events if ev[1] >= t0 and ev[2] <= t1 and match(ev[0])]


def label_gap(gap: Tuple[float, float], spans: Sequence[Tuple[float, float, str]], default: str) -> str:
    """What the host was doing in a device idle gap: the label of the host
    spans that cover most of it, else ``default``."""
    cover: Dict[str, float] = defaultdict(float)
    for s, e, label in spans:
        o = min(e, gap[1]) - max(s, gap[0])
        if o > 0:
            cover[label] += o
    if not cover:
        return default
    label, o = max(cover.items(), key=lambda kv: kv[1])
    return label if o >= 0.5 * (gap[1] - gap[0]) else default


def breakdown(events, spans, t0: float, t1: float, default: str, top: int = 10) -> Optional[Dict]:
    """The device operations that took most time in the window, and its
    longest idle gaps named by what the host was doing."""
    inside = clip(events, t0, t1)
    ops = sorted(by_name(inside).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(busy_intervals(events, t0, t1), t0, t1), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[f"{label_gap(g, spans, default)} @ {g[0] - t0:.3f}s", g[1] - g[0]] for g in gaps]}
