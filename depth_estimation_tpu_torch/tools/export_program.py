"""Console entry: export a frame program as a ``torch.export`` artifact (``.pt2``).

See ``utils/export.py`` for the design; ``depth-export-torch --model-type
DPT_Large --hw 480 640 --out dpt.pt2`` after install, or
``python -m depth_estimation_tpu_torch.tools.export_program``. The program is
exported for ``--device`` (``cuda`` unless asked for ``cpu``) and runs there.
"""

from __future__ import annotations

import argparse
import pathlib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-type", default="DPT_Large",
                    choices=("MiDaS_small", "MiDaS", "DPT_Large", "DPT_Hybrid"))
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--fused", action="store_true",
                    help="export the FUSED program (depth + detection + FaceMesh/iris + BlazePose fallback + "
                         "postprocess + sampling) instead of depth-only")
    ap.add_argument("--device", default="cuda", help="device the program runs on (default: cuda)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    if args.batch != 1 and not args.batched:
        ap.error("--batch requires --batched (a single-frame artifact has no batch axis)")
    if args.fused and args.batched:
        ap.error("--fused exports the single-frame fused program")

    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.utils.export import export_frame_program, export_fused_program

    est = DepthEstimator(args.model_type, dtype=args.dtype, device=args.device)
    if args.fused:
        from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
        from depth_estimation_tpu_torch.geometry.face import FaceDet

        det = PersonDetector(FaceDet(20, [505, 504, 675, 501]), device=args.device)
        blob = export_fused_program(est, det, tuple(args.hw))
    else:
        blob = export_frame_program(est, tuple(args.hw), batched=args.batched, batch=args.batch)
    out = pathlib.Path(args.out)
    out.write_bytes(blob)
    shape = (f"({args.batch}, {args.hw[0]}, {args.hw[1]}, 3)" if args.batched
             else f"({args.hw[0]}, {args.hw[1]}, 3)")
    kind = "fused " if args.fused else ""
    print(f"exported {kind}{args.model_type} {shape} -> {out} ({len(blob)} bytes)")


if __name__ == "__main__":
    main()
