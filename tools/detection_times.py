#!/usr/bin/env python3
"""Host ms of the port's detector programs on the card, for comparing two checkouts in one call.

    python3 tools/detection_times.py [--root DIR] [--n 64]

Imports ``depth_estimation_tpu_torch`` and ``chip_smoke`` from DIR (default:
this checkout), builds the detectors on ``chip_smoke.detector_weights(0)``
under an empty weight cache, and times on one 480×640 synthetic frame, each
after 4 set-up calls: the detection program (``FusedDetectionRunner``, the
frame's copy in and the packed row's copy out included) and the staged
``PersonDetector.findIris`` (BlazeFace, then FaceMesh+iris on the crop).
Each call ends in a host copy, so the host clock covers the device's work.
Prints one JSON line: the median and quartiles of ``n`` calls each, and the
card's ``nvidia-smi`` name and power limit. Run parent and change in turns
(parent, change, change, parent) in one call: host times move between calls.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"p25_ms": q[0], "median_ms": statistics.median(xs), "p75_ms": q[2]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=64)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["DEPTH_ESTIMATION_TPU_TORCH_CACHE"] = tempfile.mkdtemp(prefix="detection_times_cache_")

    import torch

    if not torch.cuda.is_available():
        print("detection_times: no CUDA GPU is available", file=sys.stderr)
        return 1
    import chip_smoke
    from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        weights = chip_smoke.detector_weights(seed=0)
        runner = FusedDetectionRunner(chip_smoke.make_face_detector(weights))
        det = chip_smoke.make_detector(weights)
    frame = SyntheticSource(1, 480, 640).read()[1]
    calls = {"detection_program": lambda: runner(frame), "staged_find_iris": lambda: det.findIris(frame)}
    out = {"root": root}
    for name, call in calls.items():
        for _ in range(4):
            call()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.n):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = _quartiles(times)
    out["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                       capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
