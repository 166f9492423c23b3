"""Online serving: dynamic batching of concurrent depth requests (JAX
``runtime/server.py``).

``MultiStream`` (runtime/multistream.py) serves a fixed fleet of video feeds;
this module serves independent clients that submit single frames at
unpredictable times:

* requests queue on the host; a dispatcher thread drains up to
  ``max_batch`` of them, pads the batch to exactly ``max_batch`` by
  repeating the last frame and runs one batched frame program: one shape
  for the server's lifetime, so cuDNN's timed algorithm choice
  (``device.conv_algorithms_by_timing``) is paid once, at ``warm`` or the
  first dispatch;
* a partial batch dispatches after ``max_delay_ms``, the latency/throughput
  knob;
* results come back as futures, each a host numpy copy of its request's
  rows of the batch's one device→host transfer.

:class:`DepthServer` (the u8 depth map a request) and
:class:`FusedDepthServer` (the fused iris/pose + depth program's outputs a
request; stateless, so the body-fallback sample is taken at zeros) share the
dispatcher core; :class:`BucketedDepthServer` routes mixed resolutions to
one DepthServer a (H, W), bounded by ``max_buckets``. Several dispatcher
threads may run frame programs at once: the programs' numerics are entered
through the reference-counted contexts of ``device.py`` only.

No sockets here by design: this queue + futures API is the part a gRPC/HTTP
front end would wrap.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np

from depth_estimation_tpu_torch.runtime import tracing
from depth_estimation_tpu_torch.runtime.fused import FusedFrameRunner
from depth_estimation_tpu_torch.runtime.stream import FusedFetch


class _DynamicBatcher:
    """Queue + futures + padded static-shape dispatch loop; subclasses
    implement ``_dispatch(frames) -> list of per-request results``."""

    def __init__(self, hw: Tuple[int, int], max_batch: int, max_delay_ms: float):
        self.hw = (int(hw[0]), int(hw[1]))
        self.max_batch = max(1, int(max_batch))
        self.max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._requests = itertools.count()
        self.batches_dispatched = 0
        self.frames_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, frame_u8: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) uint8 frame; thread-safe."""
        frame_u8 = np.asarray(frame_u8)
        if frame_u8.shape != (*self.hw, 3) or frame_u8.dtype != np.uint8:
            raise ValueError(f"expected {(*self.hw, 3)} uint8, got {frame_u8.shape} {frame_u8.dtype}")
        fut: Future = Future()
        # the closed check and the enqueue are one step against close(): a
        # submit behind the shutdown sentinel would strand its future
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            # the client may reuse its buffer; the request's number and submit
            # time are for the dispatcher's server.queue span
            self._q.put((frame_u8.copy(), fut, next(self._requests), time.perf_counter()))
        return fut

    def warm(self) -> None:
        """One dispatch of a zero frame: cuDNN's algorithm choice at this
        server's batch, made before any request that is timed."""
        self.submit(np.zeros((*self.hw, 3), np.uint8)).result()

    def close(self) -> None:
        """Stop the dispatcher after serving everything already queued (the
        shutdown sentinel enters the queue behind them)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher ----------------------------------------------------------

    def _dispatch(self, frames):  # pragma: no cover - abstract
        """Pad, run and fetch one batch: its outputs on the host."""
        raise NotImplementedError

    def _row(self, host, i):  # pragma: no cover - abstract
        """Request ``i``'s result from the batch's host outputs."""
        raise NotImplementedError

    def _take(self, item, batch: int):
        """Dequeue ``item`` for ``batch``: its server.queue span ends now."""
        if item is not None:
            tracing.emit("server.queue", item[3], time.perf_counter(), req=item[2], batch=batch)
        return item

    def _collect(self, batch: int) -> Optional[list]:
        """Block for the first request, then drain up to max_batch - 1 more,
        waiting at most max_delay_s for stragglers."""
        with tracing.span("server.idle", batch=batch):
            first = self._take(self._q.get(), batch)
        if first is None:
            return None
        reqs = [first]
        with tracing.span("server.collect", batch=batch):
            t_end = time.perf_counter() + self.max_delay_s
            while len(reqs) < self.max_batch:
                try:
                    item = self._take(self._q.get(timeout=max(0.0, t_end - time.perf_counter())), batch)
                except queue.Empty:
                    break
                if item is None:
                    self._q.put(None)  # shut down after this batch
                    break
                reqs.append(item)
        return reqs

    def _loop(self) -> None:
        for batch in itertools.count():
            reqs = self._collect(batch)
            if reqs is None:
                break
            # claim each future: resolving one that a client cancelled while
            # it was queued raises InvalidStateError and would end this thread
            reqs = [(f, fut) for f, fut, *_ in reqs if fut.set_running_or_notify_cancel()]
            if not reqs:
                continue
            with tracing.span("server.dispatch", batch=batch, rows=len(reqs), padded=self.max_batch - len(reqs)):
                try:
                    host = self._dispatch([f for f, _ in reqs])
                    with tracing.span("server.resolve", batch=batch):
                        results = [self._row(host, i) for i in range(len(reqs))]
                        self.batches_dispatched += 1
                        self.frames_served += len(reqs)
                        for res, (_, fut) in zip(results, reqs):
                            fut.set_result(res)
                except Exception as e:  # every waiter sees the failure; the thread serves on
                    for _, fut in reqs:
                        fut.set_exception(e)
        # shutdown: fail anything still queued
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and item[1].set_running_or_notify_cancel():
                item[1].set_exception(RuntimeError("server closed"))

    def _pad(self, frames) -> np.ndarray:
        """Pad to the one batch shape; the padded rows are discarded."""
        with tracing.span("server.pad"):
            return np.stack(frames + [frames[-1]] * (self.max_batch - len(frames)))


class DepthServer(_DynamicBatcher):
    """Dynamic-batching depth service over one estimator, for frames of one
    resolution ``hw`` (one server a resolution; ``BucketedDepthServer``
    routes mixed ones).

    Usage::

        srv = DepthServer(est, (480, 640), max_batch=8, max_delay_ms=5)
        fut = srv.submit(frame_u8)        # thread-safe, returns a Future
        depth_u8 = fut.result()
        srv.close()

    A dispatch is the estimator's frame program on the padded batch
    (``_batched_fn(hw, output)``: one K2, the network, one K3 launch), its
    (max_batch, H, W) result copied to the host once."""

    def __init__(self, estimator, hw: Tuple[int, int], max_batch: int = 8, max_delay_ms: float = 5.0,
                 output: str = "u8"):
        self.estimator = estimator
        self._fn = estimator._batched_fn((int(hw[0]), int(hw[1])), output)
        super().__init__(hw, max_batch, max_delay_ms)

    def submit(self, frame_u8: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) uint8 frame; resolves to its (H, W) depth
        output (u8 by default: the wrap-around cast made by K3)."""
        return super().submit(frame_u8)

    def _dispatch(self, frames):
        preds = self._fn(self._pad(frames))
        with tracing.span("server.fetch"):
            return preds.cpu().numpy()

    def _row(self, host, i):
        # a copy: a row view would keep the whole padded batch alive for as
        # long as its client keeps it
        return host[i].copy()


class FusedDepthServer(_DynamicBatcher):
    """Dynamic-batching service for the fused iris/pose + depth program:
    each request resolves to that program's outputs for its frame (JAX
    ``FusedDepthServer``'s dict: boxes, scores, valid, mesh, mesh_score, the
    iris circles, the pose fallback, ``vis_u8`` (H, W) uint8 and the depth
    samples; no ``depth``).

    Stateless by design: requests are independent frames, so the
    body-fallback sample (a per-stream memory of the reference loop) is
    taken at zeros; stateful clients use ``FusedVidStream``. A dispatch is
    one ``FusedFrameRunner(..., emit_depth_map=False).batched`` program on
    the padded batch (both landmark branches run for every frame), brought
    back as one packed int32 row a frame plus the u8 frames."""

    def __init__(self, estimator, detector, hw: Tuple[int, int], max_batch: int = 8, max_delay_ms: float = 5.0):
        # the capability check is on the detector (FusedVidStream's criterion):
        # the runner would take any object and fail at the first dispatch
        if not all(hasattr(detector, name) for name in ("_face_det", "_mesh", "_pose")):
            raise ValueError("FusedDepthServer needs a fused-capable PersonDetector (with _face_det/_mesh/_pose)")
        self._runner = FusedFrameRunner(estimator, detector, emit_depth_map=False)
        super().__init__(hw, max_batch, max_delay_ms)

    def submit(self, frame_u8: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) uint8 frame; resolves to the fused output
        dict for that frame."""
        return super().submit(frame_u8)

    def _dispatch(self, frames):
        fetch = FusedFetch(self._runner.batched(self._pad(frames)))
        with tracing.span("server.fetch"):
            return fetch.result()

    def _row(self, host, i):
        return {k: np.array(v) for k, v in host[i].items()}


class BucketedDepthServer:
    """Route mixed-resolution requests to one ``DepthServer`` a (H, W): the
    online counterpart of MultiStream's resolution buckets.

    Buckets are made on first sight of a resolution, whose first dispatch
    pays cuDNN's algorithm choice; :meth:`warm` the expected resolutions up
    front."""

    def __init__(self, estimator, max_batch: int = 8, max_delay_ms: float = 5.0, output: str = "u8",
                 max_buckets: int = 8):
        """``max_buckets`` bounds the servers made: each costs a dispatcher
        thread for the process's lifetime, so an unbounded resolution mix
        (or a front end walking resolutions) is refused, not absorbed."""
        self.estimator = estimator
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.output = output
        self.max_buckets = max(1, int(max_buckets))
        self._servers: dict = {}
        self._lock = threading.Lock()
        self._closed = False

    def _server_for(self, hw: Tuple[int, int]) -> DepthServer:
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            srv = self._servers.get(hw)
            if srv is None:
                if len(self._servers) >= self.max_buckets:
                    raise ValueError(f"resolution {hw} would exceed max_buckets={self.max_buckets} "
                                     f"(existing: {sorted(self._servers)})")
                srv = self._servers[hw] = DepthServer(self.estimator, hw, max_batch=self.max_batch,
                                                      max_delay_ms=self.max_delay_ms, output=self.output)
            return srv

    def warm(self, hw: Tuple[int, int]) -> None:
        """Make one bucket and run one dispatch of a zero frame in it."""
        self._server_for((int(hw[0]), int(hw[1]))).warm()

    def submit(self, frame_u8: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) uint8 frame of any resolution."""
        frame_u8 = np.asarray(frame_u8)
        if frame_u8.ndim != 3 or frame_u8.shape[-1] != 3 or frame_u8.dtype != np.uint8:
            raise ValueError(f"expected (H, W, 3) uint8, got {frame_u8.shape} {frame_u8.dtype}")
        return self._server_for(frame_u8.shape[:2]).submit(frame_u8)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            servers = list(self._servers.values())
        for srv in servers:
            srv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def stats(self) -> dict:
        """Per bucket (batches_dispatched, frames_served), from a snapshot of
        the buckets taken under the lock (a first-seen submit may be adding
        one while a monitor reads)."""
        with self._lock:
            items = list(self._servers.items())
        return {hw: (s.batches_dispatched, s.frames_served) for hw, s in items}
