"""Per-stage timing + FPS reporting (a copy of the JAX package's module).

Replicates the reference's instrumentation: ``process_time()`` brackets per
stage collected into a ``performance`` dict and a median-FPS printout at
stream end (midas_mediapipe.py:30, 52-60, 118-122) — plus wall-clock
percentiles (p50/p90 frame latency).

Truthfulness under async dispatch: the reference's ``process_time``
brackets captured real compute because torch-on-CPU is synchronous. The
pipelined loops dispatch a frame and fetch its value later, and
``process_time`` does not accrue while the host waits on the device — so a
bracket around the dispatch alone would overreport FPS arbitrarily.
Asynchronous stages therefore record via :meth:`record_completion`:
``performance`` (what the reference-format ``1 // median`` report prints)
gets the span clamped against the previous completion — true frame
COMPLETION throughput even with several frames in flight — while ``wall``
(the p50/p90 percentiles) keeps the frame's true dispatch→value-ready
LATENCY. The host-CPU share is kept separately in ``cpu``. Synchronous
host stages keep the exact reference bracket (``stage``).
"""

from __future__ import annotations

import contextlib
import time
from statistics import median
from typing import Dict, List


class StageTimer:
    def __init__(self, stages=("iris", "body", "depth")):
        self.performance: Dict[str, List[float]] = {s: [] for s in stages}
        self.wall: Dict[str, List[float]] = {s: [] for s in stages}
        self.cpu: Dict[str, List[float]] = {}
        # last record_completion timestamp per stage (overlap clamping)
        self._last_completion: Dict[str, float] = {}

    def _ensure(self, name: str) -> None:
        if name not in self.performance:
            self.performance[name] = []
            self.wall[name] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        self._ensure(name)
        c0 = time.process_time()
        w0 = time.perf_counter()
        try:
            yield
        finally:
            self.performance[name].append(time.process_time() - c0)
            self.wall[name].append(time.perf_counter() - w0)

    def record_completion(self, name: str, t_dispatch: float,
                          cpu_s: float = None, frames: int = 1) -> None:
        """Record an ASYNC stage completion happening NOW for ``frames``
        frames that were dispatched at ``t_dispatch``.

        With ``pipeline_depth`` > 1 several dispatch→value-ready spans
        overlap on the same device time; recording each raw span into the
        ``1 // median`` report would multiply-count it and understate
        throughput ~depth-fold. So the two dicts get different spans:

        * ``performance`` (the FPS report) gets the span clamped to start
          at the LATER of the dispatch and the previous completion — in
          steady state the inter-completion interval, i.e. true completion
          throughput; an idle pipeline degenerates to the raw span;
        * ``wall`` (p50/p90 latency percentiles in ``summary()``) keeps
          the TRUE unclamped dispatch→value-ready span — the latency a
          frame actually experienced, which legitimately grows with
          pipeline depth.

        Micro-batched ticks (``frames`` > 1) amortize the THROUGHPUT spans
        (``frames`` entries of clamped-span/frames), but each frame's
        latency entry is the FULL tick span — every frame of the tick
        genuinely waited from dispatch to the shared fetch."""
        now = time.perf_counter()
        self._ensure(name)
        start = max(t_dispatch, self._last_completion.get(name, 0.0))
        self._last_completion[name] = now
        per_clamped = (now - start) / frames
        true_span = now - t_dispatch
        for _ in range(frames):
            self.performance[name].append(per_clamped)
            self.wall[name].append(true_span)
            if cpu_s is not None:
                self.cpu.setdefault(name, []).append(cpu_s / frames)

    def fps(self, name: str) -> float:
        """``1 // median(stage_times)`` — the reference's formula
        (midas_mediapipe.py:120-122)."""
        times = self.performance[name]
        if not times or median(times) == 0:
            return float("inf")
        return 1 // median(times)

    def percentile(self, name: str, q: float) -> float:
        xs = sorted(self.wall[name])
        if not xs:
            return 0.0
        idx = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
        return xs[idx]

    def report(self) -> None:
        """End-of-stream print, same shape as midas_mediapipe.py:118-122."""
        print("Performance stats in FPS:")
        for name in ("iris", "body", "depth"):
            if self.performance.get(name):
                print(f"{name.capitalize()}: {self.fps(name)}")

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.wall.items():
            if not xs:
                continue
            out[name] = {
                "frames": len(xs),
                "fps_median_wall": (1.0 / median(xs)) if median(xs) else float("inf"),
                "p50_ms": self.percentile(name, 0.5) * 1e3,
                "p90_ms": self.percentile(name, 0.9) * 1e3,
            }
            if name in self._last_completion:
                # async pipelined stage: wall entries are true per-frame
                # LATENCY (grows with pipeline depth); completion
                # throughput comes from the clamped spans
                m = median(self.performance[name])
                out[name]["fps_completion"] = (1.0 / m) if m else float("inf")
            if self.cpu.get(name):
                out[name]["host_cpu_p50_ms"] = median(self.cpu[name]) * 1e3
        return out
