"""Depth-only video pipeline entry point, mirroring the reference's
depth_midas.py (depth_midas.py:89-101): pick a model type, open a video,
write raw-cast depth frames to an MJPG .avi.

Usage:
    python -m depth_estimation_tpu_torch [--model-type DPT_Large]
        [--src VIDEO|synthetic:NxHxW] [--output out.avi] [--trace [DIR]] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.runtime.stream import VidStream
from depth_estimation_tpu_torch.runtime.tracing import DEFAULT_DIR, maybe_trace


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--model-type",
        default="DPT_Large",  # reference default (depth_midas.py:91)
        choices=["DPT_Large", "DPT_Hybrid", "MiDaS_small", "MiDaS"],
    )
    parser.add_argument("--src", default="synthetic:30x480x640",
                        help="video path, camera index, or synthetic:<n>x<H>x<W>")
    parser.add_argument("--output", default="midas_output.avi")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--start-frame", type=int, default=0, help="resume from frame N")
    parser.add_argument("--microbatch", type=int, default=1,
                        help="frames per frame program (same output, ~K frames more latency)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--trace", nargs="?", const=DEFAULT_DIR, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run (Chrome trace format) into DIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = parser.parse_args(argv)

    midas = DepthEstimator(args.model_type, dtype=args.dtype, device=args.device)
    video_stream = VidStream(midas, args.src, args.output, verbose=not args.quiet,
                             start_frame=args.start_frame, microbatch=args.microbatch)
    with maybe_trace(args.trace is not None, args.trace) as tdir:
        video_stream.update()
    if tdir:
        print(f"Trace written to {tdir}")
    summary = video_stream.timer.summary()
    if "depth" in summary:
        s = summary["depth"]
        print(f"depth: {s['frames']} frames, p50 {s['p50_ms']:.1f} ms, median {s['fps_median_wall']:.1f} FPS")


if __name__ == "__main__":
    main()
