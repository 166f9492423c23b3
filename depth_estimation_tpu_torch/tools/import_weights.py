"""CLI: check external checkpoints against the port's modules and cache them.

Depth models (PyTorch hub .pt, as torch.hub.load("intel-isl/MiDaS", ...)
downloads in the reference, depth_midas.py:10):

    python -m depth_estimation_tpu_torch.tools.import_weights <ckpt.pt> <model_type>

model_type ∈ {MiDaS_small, MiDaS, DPT_Large, DPT_Hybrid}; the cache is
keyed by the file's content hash, so a re-import is a no-op.
``DepthEstimator(model_type)`` then loads it when no weights are given.

Detector models (MediaPipe .tflite, the files mediapipe 0.8.11 bundles):

    python -m depth_estimation_tpu_torch.tools.import_weights --tflite <file.tflite> [...]

Each file is copied into the TFLite cache directory
($DEPTH_ESTIMATION_TPU_TORCH_CACHE/tflite/, by default
~/.cache/depth_estimation_tpu_torch/tflite/) and converted structurally at
once; ``PersonDetector`` and ``FaceDetector`` built without weights then
load them (detect/weights.py). Exit 1 when no net matched the staged files,
2 when no file (or a missing one) was given.
"""

import os
import shutil
import sys


def _import_tflite(paths):
    from depth_estimation_tpu_torch.detect.weights import load_detector_params, tflite_dir

    if not paths:
        print(__doc__)
        return 2
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        print(f"import_weights --tflite: no such file: {missing}", file=sys.stderr)
        return 2
    dst = tflite_dir()
    dst.mkdir(parents=True, exist_ok=True)
    for p in paths:
        shutil.copy2(p, dst)
        print(f"Staged {p} -> {dst}")
    params = load_detector_params()
    if not params:
        print("No detector matched the staged files (check the expected names in detect/weights.py).")
        return 1
    for key, sd in params.items():
        n = sum(v.numel() for v in sd.values())
        print(f"Converted + verified {key}: {n/1e6:.2f}M params cached.")
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "--tflite":
        return _import_tflite(argv[1:])
    if len(argv) != 2:
        print(__doc__)
        return 2
    pt_path, model_type = argv
    from depth_estimation_tpu_torch.utils.checkpoint import import_torch_checkpoint

    sd = import_torch_checkpoint(pt_path, model_type)
    n = sum(v.numel() for v in sd.values())
    print(f"Imported {model_type}: {n/1e6:.1f}M params cached.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
