"""Multi-stream batched serving: K concurrent videos, one frame program per
resolution bucket per tick (JAX ``runtime/multistream.py``).

A server ingesting K camera feeds batches one frame from each into a
single (K, H, W, 3) frame program per tick:

* the batch is padded to a constant K after streams reach EOF: one shape a
  bucket for the whole run, so cuDNN's timed algorithm choice is paid once;
* decode runs on per-stream prefetch threads; tick t's programs are queued
  on the device before tick t-1's results are demuxed and encoded (the
  one-deep software pipeline of ``VidStream``);
* a tick's results come back as one pinned non-blocking copy a bucket,
  behind one event: the tick's only sync;
* output per stream is exactly ``VidStream``'s: the raw uint8 cast
  (wrap-around kept, made by K3) → gray→3ch → sink;
* ``microbatch=M`` reads M frames a stream a tick, a (K·M, …) batch a
  program, with the same per-stream outputs in the same order.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from depth_estimation_tpu_torch.ops.postprocess import merge_gray3
from depth_estimation_tpu_torch.runtime.stream import HostFetch
from depth_estimation_tpu_torch.runtime.timing import StageTimer
from depth_estimation_tpu_torch.runtime.video import (
    PrefetchSource,
    ResilientSource,
    needs_prefetch,
    open_sink,
    open_source,
)


class MultiStream:
    """Run K depth-only streams through batched frame programs.

    ``sources``: source specs (paths, 'synthetic:NxHxW' or FrameSource
    instances); ``outputs``: a matching list of sink specs (None → a
    NullSink each).

    Mixed resolutions are served by buckets: streams are grouped by (H, W)
    and each bucket batches into its own frame program, one program a
    bucket a tick. A uniform fleet is one bucket."""

    def __init__(self, estimator, sources: Sequence, outputs: Optional[Sequence] = None, prefetch: bool = True,
                 verbose: bool = True, retries: int = 2, microbatch: int = 1):
        """microbatch: frames read a stream a tick (≥1); M > 1 runs a (K·M,
        H, W, 3) batch and fetches its K·M u8 frames in one copy, adding
        about M frames of latency a stream (file→file serving)."""
        if outputs is None:
            outputs = [None] * len(sources)
        if len(outputs) != len(sources):
            raise ValueError(f"{len(sources)} sources but {len(outputs)} outputs")
        if not sources:
            raise ValueError("MultiStream needs at least one source")
        self.estimator = estimator
        self.videos: List = []
        for src in sources:
            v = ResilientSource(open_source(src), retries=retries)
            if prefetch and needs_prefetch(v.inner):
                v = PrefetchSource(v)
            self.videos.append(v)
        self.res = [(int(v.height), int(v.width)) for v in self.videos]
        self.buckets: dict = {}  # (H, W) -> stream indices, in order of first sight
        for i, hw in enumerate(self.res):
            self.buckets.setdefault(hw, []).append(i)
        (self.h, self.w) = self.res[0]
        self.writers = [open_sink(o, (w, h), fps=20) for o, (h, w) in zip(outputs, self.res)]
        self.alive = [True] * len(self.videos)
        self.counts = [0] * len(self.videos)
        self.microbatch = max(1, int(microbatch))
        self.verbose = verbose
        self.timer = StageTimer()

    def run(self) -> None:
        """Tick until every stream reaches EOF; one frame program a
        resolution bucket a tick, the wrap-around u8 cast made on the
        device (a quarter of the f32 map's bytes to copy back)."""
        est = self.estimator
        fns = {hw: est._batched_fn(hw, output="u8") for hw in self.buckets}
        K = len(self.videos)
        M = self.microbatch
        pending = None  # the tick in flight
        tick = 0
        while any(self.alive):
            # host decode into fresh buffers each tick
            staged = []  # (hw, stream indices, host batch, frames read a slot)
            for hw, idxs in self.buckets.items():
                batch = np.zeros((len(idxs) * M, *hw, 3), np.uint8)
                valid = []
                for slot, i in enumerate(idxs):
                    v = self.videos[i]
                    m = 0
                    if self.alive[i]:
                        while m < M:
                            ok, frame = v.read()
                            if not ok:
                                self.alive[i] = False
                                break
                            batch[slot * M + m] = frame
                            m += 1
                        self.counts[i] += m
                    # dead and short slots stay zero or padded (one shape a
                    # bucket); their results are never written
                    if 0 < m < M:
                        batch[slot * M + m:(slot + 1) * M] = batch[slot * M + m - 1]
                    valid.append(m)
                if any(valid):
                    staged.append((hw, idxs, batch, valid))
            if not staged:
                break
            # dispatch every bucket and queue the copies; t0 marks the
            # dispatch, so the depth span leaves host decode out
            c0 = time.process_time()
            t0 = time.perf_counter()
            fetch = HostFetch(*(fns[hw](batch) for hw, _, batch, _ in staged))
            entries = [(idxs, valid) for _, idxs, _, valid in staged]
            cpu_d = time.process_time() - c0
            if pending is not None:
                self._demux(*pending)
            pending = (entries, fetch, t0, cpu_d)
            tick += 1
            if self.verbose:
                live = sum(1 for a in self.alive if a)
                print(f"Tick: {tick} ({live}/{K} live)")
        if pending is not None:
            self._demux(*pending)
        for v in self.videos:
            v.release()
        for w in self.writers:
            w.release()
        if self.verbose:
            print(f"Sucessfully read {sum(self.counts)} frames over {K} streams.")
            if self.timer.performance.get("depth"):
                per_tick = (f"x{K * M} frames/tick" if len(self.buckets) == 1
                            else f"{len(self.buckets)} resolution buckets, up to x{K * M} frames/tick")
                print(f"Depth: {self.timer.fps('depth')} (batched ticks; {per_tick})")

    def _demux(self, entries, fetch, t0, cpu_d) -> None:
        c0 = time.process_time()
        fetched = fetch.result()  # the tick's one wait, for every bucket
        # one completion span a tick, dispatch → values on the host, clamped
        # against the previous tick's (runtime/timing.py)
        self.timer.record_completion("depth", t0, cpu_d + time.process_time() - c0)
        M = self.microbatch
        for (idxs, valid), preds in zip(entries, fetched):
            for slot, m in enumerate(valid):
                for j in range(m):
                    self.writers[idxs[slot]].write(merge_gray3(preds[slot * M + j]))
