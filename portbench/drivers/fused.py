"""``FusedVidStream`` (runtime/stream.py), the loop of
``python -m depth_estimation_tpu_torch.midas_mediapipe --microbatch K``, on a
source and a sink of the benchmark's own. Its cell:

    python3 portbench/run.py --workload fused_iris.video_mb4 --seed 1 --seconds 30 --trace 0

First the configuration's score heads are set from the seed
(``reference/fused_iris.score_biased``: half the seed's first 16 frames, one
a pool frame, above the detection threshold, half below) and the run's
configuration replaced by the result, so that the program here and the
reference in the check draw the same weights.

The program: ``DepthEstimator`` on the ``depth.`` part of the seed's weights
and ``PersonDetector`` on its ``blazeface.``, ``facemesh.`` and
``blazepose.`` parts (the pose detector, which this loop never runs, keeps
the program's own random weights), around a ``FaceDet`` built as
midas_mediapipe.py builds it (the card's endpoints at 20 inches; faithful,
so the program takes the depth samples). Traffic keys: ``microbatch``,
``pipeline_depth`` and ``arrivals`` (``closed``: the source hands out the
next frame as soon as the loop asks, until the window's end). A frame is
done when its side-by-side frame reaches the sink. Set-up runs a short
stream at the cell's microbatch, which warms the one program shape and both
host routes' code.

Each frame's served fields are taken from the program's outputs as the loop
hands them to the frame's host half: slot 0 of ``valid`` and ``boxes``, the
mesh, circles, pose and samples, the output frame (``vis_u8``, decoded to the
depth's own u8 cast after the window: ``reference/fused_iris.decode_vis``),
each depth sample beside the configuration's ``sample_scale`` (``on_scale``),
and the stored fallback points its tick was dispatched with
(``fallback_pts``, which the reference takes as given). Under ``--trace 1``
the window runs inside ``tracing.record()`` and the program's spans join the
outcome's host spans as ``(start, end, name)``.
"""

from __future__ import annotations

import contextlib

import numpy as np

from portbench import spec as specs
from portbench.harness import Outcome
from portbench.reference.fused_iris import decode_vis, on_scale, score_biased

FIELDS = ("mesh", "mesh_score", "l_center", "l_radius", "r_center", "r_radius", "pose_lm", "pose_score")
SAMPLES = ("iris_sample", "fallback_sample", "ears_sample")
NETS = ("blazeface", "facemesh", "blazepose")


def _programs(ctx):
    from depth_estimation_tpu_torch.config import CARD
    from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.geometry.face import FaceDet

    from portbench.weights import make_weights

    weights = make_weights(ctx.config, ctx.seed, ctx.device)
    ctx.mark("weights")
    parts = {net: {k[len(net) + 1:]: v for k, v in weights.items() if k.startswith(net + ".")}
             for net in ("depth", *NETS)}
    del weights
    est = DepthEstimator(ctx.config["model_type"], params=parts.pop("depth"), dtype=ctx.config["dtype"],
                         device=ctx.device, verbose=False)
    face = FaceDet(20, np.array(CARD))  # midas_mediapipe.py:174-178
    thresh = float(ctx.config["detectors"]["blazeface"]["min_detection_con"])
    detector = PersonDetector(face, minDetectionCon=thresh, params=parts, device=ctx.device)
    ctx.mark("programs")
    return est, detector, face


def run(ctx) -> Outcome:
    from depth_estimation_tpu_torch.runtime import tracing
    from depth_estimation_tpu_torch.runtime.stream import FusedVidStream

    Source, Sink = specs.driver("stream")._classes()
    t = ctx.traffic
    hw = tuple(ctx.config["input_hw"])
    K, depth = int(t["microbatch"]), int(t.get("pipeline_depth", 2))
    ctx.config = score_biased(ctx.config, ctx.seed, ctx.frames, ctx.device)
    ctx.mark("score bias")
    est, detector, face = _programs(ctx)
    kept = {}
    ticks = []  # the fallback points of each tick, in dispatch order

    class Stream(FusedVidStream):
        keep = False

        def _host_frame(self, frame, out, had_pts, n):
            if self.keep:
                kept[n - 1] = {"valid": np.array(out["valid"][0]), "boxes": np.array(out["boxes"][0]),
                               "vis_u8": np.array(out["vis_u8"]), **{f: np.array(out[f]) for f in FIELDS},
                               **{f: on_scale(np.array(out[f]), ctx.config) for f in SAMPLES},
                               "fallback_pts": ticks[(n - 1) // K][0]}
            super()._host_frame(frame, out, had_pts, n)

    def stream(src, sink, keep):
        vs = Stream(est, detector, face, src=src, output=sink, verbose=False, microbatch=K, pipeline_depth=depth)
        vs.keep = keep
        batched = vs._runner.batched

        def dispatch(imgs, fallback_pts=None):
            if keep:
                ticks.append(np.array(fallback_pts, np.int32))
            return batched(imgs, fallback_pts)
        vs._runner.batched = dispatch
        return vs

    stream(Source(ctx.frames, hw, count=K * (depth + 2)), Sink(keep=False), keep=False).stream()

    with tracing.record() if ctx.trace is not None else contextlib.nullcontext([]) as program_spans:
        t0 = ctx.begin_window()
        src, sink = Source(ctx.frames, hw, until=ctx.t1, start=t0), Sink(keep=False)
        vs = stream(src, sink, keep=True)
        vs.stream()
        ctx.end_window()
    spans = list(sink.spans) + [(s.start, s.end, s.name) for s in program_spans]

    for fields in kept.values():
        fields["vis_u8"] = decode_vis(fields["vis_u8"])
    done = list(sink.done) + [None] * (src.n - len(sink.done))

    def release():
        est.model = None
        detector._face_det = detector._mesh = detector._pose_det = detector._pose = None

    return Outcome(attempted=src.n, failed=0, due=None, done=done, outputs=kept, output="u8", rows_per_program=K,
                   release=release, stream_wall=list(vs.timer.wall["depth"]), spans=spans,
                   idle_default="host: fused loop, program dispatch, host halves")
