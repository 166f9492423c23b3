"""Fused iris/pose + depth pipeline, mirroring the reference's
midas_mediapipe.py (midas_mediapipe.py:163-187): calibrate a ``FaceDet``
from the credit-card endpoints, build the depth estimator and the person
detector, and stream a video through the fused frame program (or, with
``--no-fused``, the staged loop: the depth program, then ``findIris``, each
frame), writing the annotated frame and the depth frame side by side.

Weights load from the cache ($DEPTH_ESTIMATION_TPU_TORCH_CACHE, default
~/.cache/depth_estimation_tpu_torch): the depth net's from
``tools.import_weights <ckpt.pt> <model_type>``, the detector nets' from the
MediaPipe .tflite files staged by ``tools.import_weights --tflite FILE...``.
A net with nothing cached runs on random weights, with a warning.

Usage:
    python -m depth_estimation_tpu_torch.midas_mediapipe [--model-type DPT_Large]
        [--src VIDEO|synthetic:NxHxW] [--output out.avi] [--no-fused] [--microbatch K]
        [--dtype float32|bfloat16] [--trace [DIR]] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from depth_estimation_tpu_torch.config import CARD
from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.geometry.face import FaceDet
from depth_estimation_tpu_torch.runtime.stream import FusedVidStream as VidStream
from depth_estimation_tpu_torch.runtime.tracing import DEFAULT_DIR, maybe_trace


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model-type", default="DPT_Large",  # reference default (midas_mediapipe.py:165)
                        choices=["DPT_Large", "DPT_Hybrid", "MiDaS_small", "MiDaS"])
    parser.add_argument("--src", default="synthetic:30x480x640",
                        help="video path, camera index, or synthetic:<n>x<H>x<W>")
    parser.add_argument("--output", default="midas_output.avi")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--start-frame", type=int, default=0, help="resume from frame N")
    parser.add_argument("--no-fused", action="store_true",
                        help="run depth and detection as separate programs each frame (the staged loop)")
    parser.add_argument("--microbatch", type=int, default=1,
                        help="frames per fused frame program (for file-to-file runs; ~K frames more latency)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="the depth network's type; the detector nets run in float32")
    parser.add_argument("--trace", nargs="?", const=DEFAULT_DIR, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run (Chrome trace format) into DIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = parser.parse_args(argv)

    card = np.array(CARD)  # raw card endpoints in the test footage (:174)
    d_2_obj = 20  # distance to the credit card, inches (:177)
    face = FaceDet(d_2_obj, card)
    estimator = DepthEstimator(args.model_type, dtype=args.dtype, device=args.device)
    detector = PersonDetector(face, device=args.device)
    video_stream = VidStream(estimator, detector, face, args.src, args.output, verbose=not args.quiet,
                             fused=not args.no_fused, start_frame=args.start_frame, microbatch=args.microbatch)
    with maybe_trace(args.trace is not None, args.trace) as tdir:
        video_stream.stream()
    if tdir:
        print(f"Trace written to {tdir}")


if __name__ == "__main__":
    main()
