"""``VidStream`` (runtime/stream.py) on a source and a sink of the benchmark's own.

Traffic keys: ``microbatch``, ``pipeline_depth`` and ``arrivals``
(``schedule.arrivals``). A ``paced`` source hands out frame ``i`` no earlier
than its due time, as a camera does, and each frame is timed from then to
the moment its u8 map reaches the sink. A ``closed`` source hands out the
next frame as soon as the loop asks, until the window's end. The sink
keeps each map (one channel of the loop's gray frame) with the time it
arrived. Set-up runs a short stream at the cell's own microbatch, which
warms its one program shape.
"""

from __future__ import annotations

import time

from portbench import schedule
from portbench.harness import Outcome


def _classes():
    from depth_estimation_tpu_torch.runtime.video import FrameSink, FrameSource

    class Source(FrameSource):
        def __init__(self, frames, hw, due=None, until=None, count=None, start=None):
            self.frames, self.due, self.until, self.count, self.start = frames, due, until, count, start
            self.height, self.width = hw
            self.frame_count = 0.0  # unknown length: the loop stops at the first refusal
            self.n = 0
            self.handed = []  # when each frame was handed out
            self.waits = []  # host spans spent waiting for a frame's due time

        def read(self):
            i = self.n
            if self.due is not None:
                if i >= len(self.due):
                    return False, None
            elif (self.count is not None and i >= self.count) or (
                    self.until is not None and time.perf_counter() >= self.until):
                return False, None
            frame = self.frames.frame(i)
            not_before = self.due[i] if self.due is not None else (self.start if i == 0 else None)
            w0 = time.perf_counter()
            if not_before is not None and not_before > w0:
                time.sleep(not_before - w0)
                self.waits.append((w0, time.perf_counter(), "source: waiting for the next frame"))
            self.handed.append(time.perf_counter())
            self.n += 1
            return True, frame

        def is_opened(self):
            return True

    class Sink(FrameSink):
        def __init__(self, keep: bool):
            self.keep = keep
            self.done = []
            self.spans = []
            self.maps = []

        def write(self, frame):
            w0 = time.perf_counter()
            if self.keep:
                self.maps.append(frame[..., 0].copy())
            self.done.append(time.perf_counter())
            self.spans.append((w0, self.done[-1], "sink write"))

    return Source, Sink


def run(ctx) -> Outcome:
    from depth_estimation_tpu_torch.runtime.stream import VidStream

    Source, Sink = _classes()
    t = ctx.traffic
    hw = tuple(ctx.config["input_hw"])
    K, depth = int(t["microbatch"]), int(t.get("pipeline_depth", 2))
    est = ctx.estimator()

    def stream(src, sink):
        return VidStream(est, src=src, output=sink, verbose=False, microbatch=K, pipeline_depth=depth)

    warm = K * (depth + 2)
    stream(Source(ctx.frames, hw, count=warm), Sink(keep=False)).update()

    offsets = schedule.arrivals(t["arrivals"], ctx.seconds, ctx.seed)
    t0 = ctx.begin_window()
    if offsets is None:
        src = Source(ctx.frames, hw, until=ctx.t1, start=t0)
    else:
        src = Source(ctx.frames, hw, due=[t0 + off for off in offsets])
    sink = Sink(keep=True)
    vs = stream(src, sink)
    vs.update()
    ctx.end_window()

    due = src.due
    done = list(sink.done) + [None] * (src.n - len(sink.done))
    if due is None:
        outputs = dict(enumerate(sink.maps))
        lag = None
    else:
        keep = ctx.sample(len(due))
        outputs = {i: m for i, m in enumerate(sink.maps) if i in keep}
        lag = [h - d for h, d in zip(src.handed, due)]

    def release():
        est.model = None

    spans = src.waits + sink.spans
    return Outcome(attempted=src.n, failed=0, due=due, done=done, outputs=outputs, output="u8",
                   rows_per_program=K, release=release, gen_lag=lag, stream_wall=list(vs.timer.wall["depth"]),
                   spans=spans, idle_default="host: stream loop, program dispatch")
