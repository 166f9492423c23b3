"""Streaming loops: the depth-only ``VidStream`` (reference:
depth_midas.py:38-85) and the fused iris/pose + depth ``FusedVidStream``
(reference: midas_mediapipe.py:11-159; at the end of this module).

Read frame → depth frame program on the device (with the reference's raw
uint8 wrap-around cast applied there) → gray→3ch → MJPG write. A copy of the
JAX package's ``VidStream`` (``runtime/stream.py:55-225``) on PyTorch:

* decode runs on a background thread (PrefetchSource);
* the loop keeps ``pipeline_depth`` frames in flight: each frame's device→host
  copy of its u8 map is queued on the stream right after its frame program,
  into pinned memory, and the loop waits on that copy only when the frame is
  the oldest in flight, so host decode and encode overlap device compute;
* ``microbatch=K`` runs K frames per frame program and fetches them in one
  copy, with the same output frames in the same order.

The ``depth`` stage records dispatch→copy-done spans via
``StageTimer.record_completion``, so the FPS report states frame completion
throughput at any pipeline depth.
"""

from __future__ import annotations

import time
from collections import deque
from statistics import median

import numpy as np
import torch

from depth_estimation_tpu_torch.ops.postprocess import merge_gray3, side_by_side, to_video_frame
from depth_estimation_tpu_torch.runtime import tracing
from depth_estimation_tpu_torch.runtime.fused import IRIS_FIELDS, FusedFrameRunner, pack, unpack
from depth_estimation_tpu_torch.runtime.logging_utils import JsonLogger
from depth_estimation_tpu_torch.runtime.timing import StageTimer
from depth_estimation_tpu_torch.runtime.video import (
    PrefetchSource,
    ResilientSource,
    needs_prefetch,
    open_sink,
    open_source,
)


class HostFetch:
    """Device→host copies of some tensors, queued at dispatch into fresh
    pinned buffers behind one event and awaited together at completion: the
    only sync point of the loop that makes them. On the CPU the tensors are
    the result."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def result(self) -> list:
        """The tensors' values as numpy arrays, in order."""
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


class VidStream:
    """Depth-only stream (reference: depth_midas.py:38-85)."""

    def __init__(self, estimator, src=None, output=None, prefetch: bool = True,
                 verbose: bool = True, start_frame: int = 0, retries: int = 2,
                 pipeline_depth: int = 2, microbatch: int = 1):
        """start_frame: skip the first N frames before processing.
        retries: decode-failure retry budget per frame (ResilientSource).
        pipeline_depth: frames (or micro-batches) in flight on the device
        before the oldest is fetched and written (≥1; 1 = synchronous).
        microbatch: frames per frame program (≥1); K>1 adds ~K frames of
        latency, so it suits file→file transcoding, not interactive use."""
        self.estimator = estimator
        self.video = ResilientSource(open_source(src), retries=retries)
        if prefetch and needs_prefetch(self.video.inner):
            self.video = PrefetchSource(self.video)
        self.start_frame = int(start_frame)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.microbatch = max(1, int(microbatch))
        self.FPS = 1 / 30  # reference constant, unused for pacing (depth_midas.py:45)
        self.FPS_MS = int(self.FPS * 1000)
        self.w = int(self.video.width)
        self.h = int(self.video.height)
        self.writer = open_sink(output, (self.w, self.h), fps=20)
        self.status = None
        self.frame = None
        self.cnt = 0
        self.verbose = verbose
        self.timer = StageTimer()
        self.log = JsonLogger()

    def update(self):
        """Run the loop to EOF (reference semantics incl. prints)."""
        for _ in range(self.start_frame):  # deterministic resume
            ok, _f = self.video.read()
            if not ok:
                break
            self.cnt += 1
        if self.microbatch > 1:
            self._update_microbatched()
        else:
            self._update_per_frame()
        dropped = getattr(self.video, "frames_dropped", 0)
        if dropped and self.verbose:
            print(f"Dropped {dropped} undecodable frames.")
        self.video.release()
        self.writer.release()
        if self.log.enabled:
            self.log.log("stream_end", frames=self.cnt, frames_dropped=dropped,
                         **self.timer.summary())
            self.log.close()

    def _update_per_frame(self):
        inflight = deque()  # (fetch, n_frames, t_dispatch, cpu_dispatch, first frame index)
        while True:
            if not self.video.is_opened():
                print("Error opening file.")
                print(f"Sucessfully read {self.cnt} out of {self.video.frame_count} frames.")
                break
            first = self.cnt
            with tracing.span("stream.read", frame=first, rows=1):
                self.status, self.frame = self.video.read()
            if not self.status:
                break
            self.cnt += 1
            if self.verbose:
                print(f"Frame: {self.cnt}")
            c0 = time.process_time()
            t0 = time.perf_counter()
            with tracing.span("stream.dispatch", frame=first, rows=1):
                fetch = HostFetch(self.estimator.predict_device_u8(self.frame)[None])
            inflight.append((fetch, 1, t0, time.process_time() - c0, first))
            if len(inflight) >= self.pipeline_depth:
                self._complete(inflight)
        while inflight:
            self._complete(inflight)

    def _update_microbatched(self):
        """K frames per frame program, one K-frame fetch per tick (same
        output frames and order as the per-frame loop; the per-frame 'depth'
        spans record the amortized batch wall)."""
        K = self.microbatch
        fn = self.estimator._batched_fn((self.h, self.w), output="u8")
        inflight = deque()
        eof = False
        while not eof:
            if not self.video.is_opened():
                print("Error opening file.")
                print(f"Sucessfully read {self.cnt} out of {self.video.frame_count} frames.")
                break
            batch = np.empty((K, self.h, self.w, 3), np.uint8)
            m = 0
            first = self.cnt
            with tracing.span("stream.read", frame=first, rows=K):
                while m < K:
                    self.status, frame = self.video.read()
                    if not self.status:
                        eof = True
                        break
                    self.frame = frame
                    batch[m] = frame
                    m += 1
                    self.cnt += 1
                    if self.verbose:
                        print(f"Frame: {self.cnt}")
            if m == 0:
                break
            if m < K:  # tail tick: pad with the last decoded frame (one
                batch[m:] = batch[m - 1]  # program shape; padding discarded)
            c0 = time.process_time()
            t0 = time.perf_counter()
            with tracing.span("stream.dispatch", frame=first, rows=m):
                fetch = HostFetch(fn(batch))
            inflight.append((fetch, m, t0, time.process_time() - c0, first))
            if len(inflight) >= self.pipeline_depth:
                self._complete(inflight)
        while inflight:
            self._complete(inflight)

    def _complete(self, inflight):
        """Wait for the oldest in-flight copy, record its frames' depth
        spans and write them."""
        fetch, m, t0, cpu_d, first = inflight.popleft()
        c0 = time.process_time()
        with tracing.span("stream.fetch", frame=first, rows=m):
            grays, = fetch.result()
        self.timer.record_completion("depth", t0, cpu_d + time.process_time() - c0, frames=m)
        with tracing.span("stream.write", frame=first, rows=m):
            for i in range(m):
                self._write_gray(grays[i])

    def _write_gray(self, gray):
        """gray→3ch and write (depth_midas.py:84-85); the uint8 cast already
        happened on the device."""
        self.writer.write(merge_gray3(gray))

    # reference alias
    def write_output(self):
        self._write_gray(HostFetch(self.estimator.predict_device_u8(self.frame)[None]).result()[0][0])


# -- the fused iris/pose + depth loop ------------------------------------------

class FusedFetch:
    """A fused program's outputs for the host, queued at dispatch: the small
    outputs packed into one int32 row a frame (``IRIS_FIELDS`` that the
    program returns), the u8 output frames and, where the program emits it,
    the f32 depth map, as pinned non-blocking copies behind one event."""

    def __init__(self, out):
        self._fields = tuple(f for f in IRIS_FIELDS if f[0] in out)
        self._depth = "depth" in out
        with torch.inference_mode():
            self._fetch = HostFetch(pack(out, self._fields), out["vis_u8"], *([out["depth"]] if self._depth else []))

    def result(self):
        """Each frame's outputs: a dict of numpy values (views of the
        fetched buffers) with ``vis_u8`` (H, W) and, if emitted, ``depth``."""
        packed, vis, *depth = self._fetch.result()
        return [{**unpack(packed[j], self._fields), "vis_u8": vis[j], **({"depth": depth[0][j]} if depth else {})}
                for j in range(len(packed))]


class FusedVidStream:
    """Fused iris/pose + depth stream (reference: midas_mediapipe.py:11-159),
    a copy of the JAX package's ``FusedVidStream``.

    Each tick reads K = ``microbatch`` frames (1 per frame) and dispatches
    one fused frame program (``runtime/fused.py``): depth, face detection,
    FaceMesh+iris, the BlazePose fallback, the output frame and the depth
    samples, with the results queued for copy. Up to ``pipeline_depth``
    ticks are in flight; the oldest is then completed in frame order: the
    face state filled, a depth sample recorded, the iris or body path taken,
    the HUD drawn and the side-by-side frame written. Body-fallback
    sampling points are up to K·``pipeline_depth`` frames stale, as in the
    JAX loop (docs/PARITY.md).

    ``fused=False`` is the staged loop (JAX stream.py:338-361, the
    reference's own order): each frame, the depth program and a copy of its
    f32 map to the host (stage ``depth``), ``detector.findIris`` (stage
    ``iris``), ``face.get_depth`` on the host map, and the iris or body
    path, synchronously.

    Spans (``runtime/tracing.py``): the fused loop's ticks record
    ``stream.read``, ``stream.dispatch`` (the program's ``program`` inside)
    and ``stream.fetch`` (frame: the tick's first, 0-based; rows), and each
    frame's host half one ``stream.host_frame`` (frame); in both loops the
    route taken is a ``stream.iris_path`` or ``stream.body_path``, one a
    frame, as ``route_counts`` counts them."""

    def __init__(self, estimator, detector, face, src=None, output=None, verbose: bool = True, *,
                 fused: bool = True, start_frame: int = 0, retries: int = 2, pipeline_depth: int = 2,
                 microbatch: int = 1):
        """pipeline_depth: ticks in flight before the oldest is completed (1
        is synchronous, the reference's order). microbatch: frames a program
        (the fused loop only). The fused program's samples are
        ``FaceDet.get_depth``'s faithful ones; with a ``faithful=False``
        face the program also emits its f32 map, which is fetched, and the
        host samples it (JAX stream.py:257-265)."""
        self.fused = bool(fused)
        self.microbatch = max(1, int(microbatch))
        if not self.fused and self.microbatch > 1:
            raise ValueError("microbatch>1 requires the fused pipeline")
        self.detector = detector
        self.estimator = estimator
        self.face = face
        self.video = ResilientSource(open_source(src), retries=retries)
        if needs_prefetch(self.video.inner):
            self.video = PrefetchSource(self.video)
        self.start_frame = int(start_frame)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._device_samples = bool(getattr(face, "faithful", True))
        self._runner = (FusedFrameRunner(estimator, detector, emit_depth_map=not self._device_samples)
                        if self.fused else None)
        self._fused_pose = None  # the current frame's pose landmarks from the program
        self.FPS = 1 / 30
        self.FPS_MS = int(self.FPS * 1000)
        self.w = int(self.video.width)
        self.h = int(self.video.height)
        # two half-size frames side by side (midas_mediapipe.py:27)
        self.writer = open_sink(output, (self.w, self.h // 2), fps=20)
        self.status = False
        self.frame = None
        self.cnt = 0
        self.timer = StageTimer()
        self.performance = self.timer.performance  # reference-compatible dict
        self.verbose = verbose
        self.log = JsonLogger()
        self.route_counts = {"iris": 0, "body": 0}

    def stream(self):
        for _ in range(self.start_frame):  # deterministic resume
            ok, _f = self.video.read()
            if not ok:
                break
            self.cnt += 1
        if not self.fused:
            return self._stream_staged()
        K = self.microbatch
        inflight = deque()  # (fetch, frames, first frame number, had_pts, t_dispatch, cpu_dispatch)
        eof = open_error = False
        while not eof:
            if not self.video.is_opened():
                while inflight:
                    self._complete(inflight.popleft())
                print("Error opening file.")
                print(f"Sucessfully read {self.cnt} out of {self.video.frame_count} frames.")
                open_error = True
                break
            frames = []
            first = self.cnt
            with tracing.span("stream.read", frame=first, rows=K):
                while len(frames) < K:
                    self.status, frame = self.video.read()
                    if not self.status:
                        eof = True
                        break
                    frames.append(frame)
                    self.cnt += 1
                    if self.verbose:
                        print(f"Frame: {self.cnt}")
            if not frames:
                break
            # a tail tick pads with its last frame (one program shape); the
            # padding's results are never completed
            batch = np.stack(frames + [frames[-1]] * (K - len(frames)))
            pts = self.face.head_pts
            had_pts = pts is not None
            pts_arr = np.zeros((K, 2, 2), np.int32)
            if had_pts:
                pts_arr[:] = [[int(pts[0][0]), int(pts[0][1])], [int(pts[1][0]), int(pts[1][1])]]
            c0 = time.process_time()
            t0 = time.perf_counter()
            with tracing.span("stream.dispatch", frame=first, rows=len(frames)):
                fetch = FusedFetch(self._runner.batched(batch, fallback_pts=pts_arr))
            inflight.append((fetch, frames, first + 1, had_pts, t0, time.process_time() - c0))
            if len(inflight) >= self.pipeline_depth:
                self._complete(inflight.popleft())
        while inflight:
            self._complete(inflight.popleft())
        self._end(report=not open_error)

    def _stream_staged(self):
        """The staged loop: one frame at a time, depth then findIris, each a
        program of its own, then the host half."""
        open_error = False
        while True:
            if not self.video.is_opened():
                print("Error opening file.")
                print(f"Sucessfully read {self.cnt} out of {self.video.frame_count} frames.")
                open_error = True
                break
            self.status, self.frame = self.video.read()
            if not self.status:
                break
            self.cnt += 1
            if self.verbose:
                print(f"Frame: {self.cnt}")
            self.face.mesh = None  # per-frame detection reset (:51)
            self._fused_pose = None
            with self.timer.stage("depth"):
                depth_frame = self.estimator.predict_device(self.frame).cpu().numpy()
            with self.timer.stage("iris"):
                self.detector.findIris(self.frame)
            # sampling falls back to the stored body head points when there is
            # no mesh; on the first frames neither may exist yet (the
            # reference would crash on a face-less first frame, face.py:112)
            if self.face.mesh is not None or self.face.head_pts is not None:
                self.face.get_depth(depth_frame)
                self.face.rel2abs()
            self._log_frame(self.cnt)
            self._route_frame(to_video_frame(depth_frame))
        self._end(report=not open_error)

    def _end(self, report: bool):
        if report:
            self.timer.report()  # end-of-stream report (midas_mediapipe.py:118-122)
        dropped = getattr(self.video, "frames_dropped", 0)
        if dropped and self.verbose:
            print(f"Dropped {dropped} undecodable frames.")
        if self.log.enabled:
            self.log.log("stream_end", frames=self.cnt, frames_dropped=dropped, **self.timer.summary())
            self.log.close()
        self.video.release()
        self.writer.release()

    def _complete(self, entry):
        """Wait for a tick's copies, record its frames' depth spans, then run
        each frame's host half in order."""
        fetch, frames, first_n, had_pts, t0, cpu_d = entry
        c0 = time.process_time()
        with tracing.span("stream.fetch", frame=first_n - 1, rows=len(frames)):
            outs = fetch.result()
        self.timer.record_completion("depth", t0, cpu_d + time.process_time() - c0, frames=len(frames))
        for j, frame in enumerate(frames):
            self._host_frame(frame, outs[j], had_pts, first_n + j)

    def _host_frame(self, frame, out, had_pts, n):
        """One frame's host half: the face state, the depth sample (recorded
        before the path choice, midas_mediapipe.py:62), HUD and output. ``n``
        is the frame's 1-based number."""
        with tracing.span("stream.host_frame", frame=n - 1):
            self.frame = frame
            self.face.mesh = None  # per-frame detection reset (:51)
            found = bool(out["valid"][0])
            self.detector.set_fused_mesh(frame, out["mesh"], out["mesh_score"], out["l_center"], out["l_radius"],
                                         out["r_center"], out["r_radius"], found=found)
            self._fused_pose = None if found else (out["pose_lm"], out["pose_score"])
            if not self._device_samples:  # the host samples the fetched map
                if self.face.mesh is not None or self.face.head_pts is not None:
                    self.face.get_depth(out["depth"])
                    self.face.rel2abs()
                sample = None
            elif found:
                sample = out["iris_sample"]
            elif had_pts:
                sample = out["fallback_sample"]
            elif self.face.head_pts is not None:
                # head points appeared only after this frame was dispatched:
                # sample at the frame's own ears (docs/PARITY.md)
                sample = out["ears_sample"]
            else:
                sample = None
            if sample is not None:
                self.face.record_depth(float(sample))
                self.face.rel2abs()
            self._log_frame(n)
            self._route_frame(merge_gray3(out["vis_u8"]))

    def _log_frame(self, n):
        if self.log.enabled:
            self.log.log("frame", n=n, ri_depth=float(self.face.ri_depth),
                         abs_depth=float(self.face.abs_depth), face_found=self.face.mesh is not None)

    def _route_frame(self, vis):
        """Degenerate-iris guard, then the iris or body path on the current
        face state; ``vis`` is the 3-channel u8 depth frame."""
        if self.face.mesh is not None and not (self.face.l_iris["radius"] or 0) > 0:
            # a degenerate iris fit goes the body way instead of dividing by 0
            self.face.mesh = None
        if self.face.mesh is not None:
            self.route_counts["iris"] += 1
            with tracing.span("stream.iris_path"):
                self._iris_path(vis)
        else:
            self.route_counts["body"] += 1
            with tracing.span("stream.body_path"):
                self._body_path(vis)

    # -- iris path (midas_mediapipe.py:64-94) -------------------------------

    def _iris_path(self, vis):
        self.detector.visualize(self.frame)
        l_diameter = self.face.l_iris["radius"] * 2
        self.face.s2c_dist(self.face.w_iris, l_diameter)
        x1, y1 = self.face.mesh[self.detector.HEAD[0]]
        x2, y2 = self.face.mesh[self.detector.HEAD[1]]
        self.face.get_headw((x1, y1), (x2, y2))
        messages = [
            f"S2C Distance (ft) - iris: {str(self.face.s2c_d)}",
            f"Head width (in): {str(round((self.face.head_w / 10) / 2.54, 2))}",
            f"head_w_mm: {str(self.face.head_w)}",
            f"focal length: {round(self.face.f, 2)}",
        ]
        self.write_messages(messages, self.frame)
        self.write_messages(self._depth_messages(), vis)
        self.write_output(vis)

    # -- body fallback path (midas_mediapipe.py:95-117) ----------------------

    def _body_path(self, vis):
        self.face.rel2abs()
        self._put_text(self.frame, "Face not detected. Using body pose estimates.", (70, 50), (255, 0, 0))
        with self.timer.stage("body"):
            if self._fused_pose is not None:  # BlazePose already ran in the program
                self.frame, head_pts = self.detector.body_from_fused(self.frame, *self._fused_pose)
            else:  # a hit with a degenerate iris fit: the staged call
                self.frame, head_pts = self.detector.findBody(self.frame)
        # get_headw scales by the iris radius (face.py:88), known only once a
        # face has been seen; the reference crashes here without one
        if head_pts and len(head_pts) >= 2 and (self.face.l_iris["radius"] or 0) > 0:
            self.face.get_headw(head_pts[0], head_pts[1])
            self.face.s2c_dist(median(self.face.head_measurements), self.face.head_w)
            self._put_text(self.frame, f"S2C dist (ft): {self.face.s2c_d}", (50, 150), (0, 255, 0))
        self.write_messages(self._depth_messages(), vis)
        self.write_output(vis)

    def _depth_messages(self):
        msgs = [
            f"Relative Inverse Depth: {round(float(self.face.ri_depth), 2)}",
            f"Absolute Depth: {round(float(self.face.abs_depth), 2)}",
        ]
        if self.face.s2c_ds and self.face.abs_depths:
            msgs.append(f"RMSE: {round(self.face.rmse(), 2)}")
            msgs.append(f"MAE: {round(self.face.mae(), 2)}")
        return msgs

    # -- rendering helpers (host-side HUD) -----------------------------------

    def _put_text(self, img, text, org, color):
        try:
            import cv2

            cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 1, color, 2, cv2.LINE_AA)
        except ImportError:
            pass

    def detect_points(self, img):
        """The reference's (dead) helper (midas_mediapipe.py:136-139), kept
        for API parity: iris first, body on a miss."""
        self.detector.findIris(img)
        if self.face.mesh is None:
            self.detector.findBody(img)

    def write_messages(self, messages, img):
        for idx, m in enumerate(messages):
            self._put_text(img, m, (50, 50 + idx * 50), (0, 255, 0))

    def to_video_frame(self, img):
        """uint8 cast, ``*= 5`` and ``+= 10`` with wrap-around, gray → 3
        channels (midas_mediapipe.py:141-150) on the host. The fused program
        computes it on the device (``vis_u8``); this serves API parity."""
        return to_video_frame(img)

    def side_by_side(self, img1, img2):
        return side_by_side(img1, img2, self.w, self.h)

    def write_output(self, depth_frame):
        self.writer.write(self.side_by_side(self.frame, depth_frame))
