"""Video IO: capture sources and writers.

A copy of the JAX package's ``runtime/video.py``. The reference drives
cv2.VideoCapture/VideoWriter directly inside its stream loops
(depth_midas.py:42-50). Here IO sits behind ``FrameSource`` / ``FrameSink``
so the same streaming runtime serves:

* the C++ framepipe (``runtime/native.py``: its own decode thread and
  zero-copy ring, an asynchronous MJPG writer), which ``open_source`` and
  ``open_sink`` prefer where it is built, falling back to Python IO,
* real video files / webcams (OpenCV),
* a decode *thread* feeding a bounded queue (so decode overlaps device
  compute — the reference decodes serially in the hot loop),
* a synthetic deterministic source (``synthetic:<n>x<H>x<W>``) used by tests
  and benchmarks, byte-identical to the JAX package's, replacing the
  reference's hardcoded absolute video paths (depth_midas.py:95-98).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Tuple

import numpy as np


class FrameSource:
    """Iterator of BGR uint8 frames with reference-compatible metadata."""

    width: int = 0
    height: int = 0
    frame_count: float = 0.0

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        raise NotImplementedError

    def is_opened(self) -> bool:
        raise NotImplementedError

    def release(self) -> None:
        pass


class OpenCVSource(FrameSource):
    """cv2.VideoCapture wrapper (CAP_PROP_BUFFERSIZE=2 as depth_midas.py:43)."""

    def __init__(self, src, buffer_size: int = 2):
        import cv2

        self.video = cv2.VideoCapture(src)
        self.video.set(cv2.CAP_PROP_BUFFERSIZE, buffer_size)
        self.width = int(self.video.get(3))
        self.height = int(self.video.get(4))
        self.frame_count = self.video.get(7)

    def read(self):
        return self.video.read()

    def is_opened(self):
        return self.video.isOpened()

    def release(self):
        self.video.release()


class SyntheticSource(FrameSource):
    """Deterministic procedural frames: moving gradient + bright disc
    (stands in for the subject). Spec string: 'synthetic:<n>x<H>x<W>'."""

    def __init__(self, n_frames: int = 30, height: int = 480, width: int = 640, seed: int = 0):
        self.n = n_frames
        self.height = height
        self.width = width
        self.frame_count = float(n_frames)
        self._i = 0
        yy, xx = np.mgrid[0:height, 0:width]
        self._yy, self._xx = yy, xx
        base = (xx * 255 // max(width, 1)).astype(np.uint8)
        self._base = np.stack([base, base // 2, 255 - base], axis=-1)

    @classmethod
    def from_spec(cls, spec: str) -> "SyntheticSource":
        body = spec.split(":", 1)[1]
        n, h, w = (int(v) for v in body.split("x"))
        return cls(n, h, w)

    def read(self):
        if self._i >= self.n:
            return False, None
        t = self._i
        cx = self.width // 2 + int(0.25 * self.width * np.sin(t / 7))
        cy = self.height // 2 + int(0.1 * self.height * np.cos(t / 5))
        r = max(12, min(self.height, self.width) // 8)
        frame = self._base.copy()
        mask = (self._xx - cx) ** 2 + (self._yy - cy) ** 2 < r * r
        frame[mask] = (230, 220, 210)
        self._i += 1
        return True, frame

    def is_opened(self):
        return True


def open_source(src, prefer_native: bool = True) -> FrameSource:
    """Resolve a source spec: a FrameSource, 'synthetic:<n>x<H>x<W>', or
    anything cv2.VideoCapture opens. Prefers the C++ framepipe decoder (its
    own decode thread and zero-copy ring) where it is built and opens the
    source; falls back to Python IO."""
    if isinstance(src, FrameSource):
        return src
    if prefer_native and isinstance(src, str):
        from depth_estimation_tpu_torch.runtime import native

        if native.native_available():
            ns = native.NativeSource(src)
            if ns.is_opened():
                return ns
    if isinstance(src, str) and src.startswith("synthetic:"):
        return SyntheticSource.from_spec(src)
    return OpenCVSource(src)


def needs_prefetch(source: FrameSource) -> bool:
    """Whether ``source`` wants a ``PrefetchSource`` decode thread: native
    sources already decode on their own C++ thread."""
    from depth_estimation_tpu_torch.runtime import native

    return not isinstance(source, native.NativeSource)


class PrefetchSource(FrameSource):
    """Background decode thread + bounded queue: overlaps host decode with
    device compute (the double-buffering half of SURVEY.md §2c's streaming
    design; depth of 2 mirrors CAP_PROP_BUFFERSIZE=2)."""

    _EOF = object()

    def __init__(self, inner: FrameSource, depth: int = 2):
        self.inner = inner
        self.width = inner.width
        self.height = inner.height
        self.frame_count = inner.frame_count
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = False
        self._stop = False
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        while not self._stop:
            ok, frame = self.inner.read()
            if not ok:
                self._put(self._EOF)
                return
            if not self._put(frame):
                return

    def _put(self, item) -> bool:
        # bounded put that gives up once release() raises the stop flag, so
        # the pump thread can never block forever on a full queue
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def read(self):
        if self._done or self._stop:
            return False, None
        item = self._q.get()
        if item is self._EOF:
            self._done = True
            return False, None
        return True, item

    def is_opened(self):
        return self.inner.is_opened()

    @property
    def frames_dropped(self) -> int:
        return getattr(self.inner, "frames_dropped", 0)

    def release(self):
        # stop the pump (and drain stale buffered frames) BEFORE releasing
        # the inner source, so the thread can't read a released source and a
        # later read() can't return a stale frame
        self._stop = True
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        self.inner.release()


class ResilientSource(FrameSource):
    """Decode-failure skip/retry policy (SURVEY.md §5 failure-detection row).

    The reference treats ANY failed read as end-of-stream (depth_midas.py:57-58
    just re-prints an error). Here a read that raises, or that fails while the
    source still reports frames remaining, is retried ``retries`` times, then
    counted as a *dropped* frame and skipped; the stream only ends on a true
    EOF (frame budget exhausted / unknown-length source returning a clean
    False) or after ``max_consecutive_drops`` consecutive drops (a dead
    decoder). ``frames_dropped`` surfaces in stream summaries and JsonLogger.
    """

    def __init__(self, inner: FrameSource, retries: int = 2,
                 max_consecutive_drops: int = 5):
        self.inner = inner
        self.width = inner.width
        self.height = inner.height
        self.frame_count = inner.frame_count
        self.retries = int(retries)
        self.max_consecutive_drops = int(max_consecutive_drops)
        self.frames_dropped = 0
        self._frames_read = 0
        self._consecutive_drops = 0

    def _expect_more(self) -> bool:
        n = self.frame_count
        return bool(n and n > 0 and (self._frames_read + self.frames_dropped) < n)

    def read(self):
        # clean Falses seen in this call are *tentative* — they only become
        # dropped frames if a later read succeeds (proving the stream wasn't
        # at EOF); containers routinely overstate CAP_PROP_FRAME_COUNT, so
        # trusting metadata alone would log phantom drops at a clean EOF
        clean_false = 0
        while True:
            try:
                ok, frame = self.inner.read()
            except Exception:
                # the decoder consumed (and lost) a frame: skip-and-count,
                # give up only after a run of consecutive losses (dead decoder)
                self.frames_dropped += 1
                self._consecutive_drops += 1
                if self._consecutive_drops > self.max_consecutive_drops:
                    return False, None
                continue
            if ok:
                # clean-False reads before this success were real decode
                # gaps, not EOF: commit them as drops now
                self.frames_dropped += clean_false
                self._consecutive_drops = 0
                self._frames_read += 1
                return True, frame
            # clean False: EOF for the reference's sources — but if the
            # container metadata says frames remain, retry a bounded number
            # of times before trusting it (cv2 returns False for a corrupt
            # frame exactly as it does for EOF)
            if clean_false >= self.retries or not self._expect_more():
                return False, None
            clean_false += 1

    def is_opened(self):
        return self.inner.is_opened()

    def release(self):
        self.inner.release()


class FrameSink:
    def write(self, frame_bgr_u8: np.ndarray) -> None:
        raise NotImplementedError

    def release(self) -> None:
        pass


class OpenCVSink(FrameSink):
    """cv2.VideoWriter MJPG@20fps (reference: depth_midas.py:49-50)."""

    def __init__(self, path, size_wh: Tuple[int, int], fps: int = 20, fourcc: str = "MJPG"):
        import cv2

        self.writer = cv2.VideoWriter(
            str(path), cv2.VideoWriter_fourcc(*fourcc), fps, size_wh
        )

    def write(self, frame):
        self.writer.write(frame)

    def release(self):
        self.writer.release()


class NullSink(FrameSink):
    def __init__(self):
        self.frames_written = 0
        self.last_frame: Optional[np.ndarray] = None

    def write(self, frame):
        self.frames_written += 1
        self.last_frame = frame


def open_sink(output, size_wh: Tuple[int, int], fps: int = 20, prefer_native: bool = True) -> FrameSink:
    """None → a ``NullSink``; a path → the C++ framepipe's asynchronous MJPG
    writer where it is built with OpenCV, else cv2.VideoWriter."""
    if output is None:
        return NullSink()
    if isinstance(output, FrameSink):
        return output
    if prefer_native:
        from depth_estimation_tpu_torch.runtime import native

        if native.native_available():
            try:
                return native.NativeSink(output, size_wh, fps=fps)
            except RuntimeError:
                pass
    return OpenCVSink(output, size_wh, fps=fps)
