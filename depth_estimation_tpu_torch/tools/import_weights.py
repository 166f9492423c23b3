"""CLI: check a PyTorch hub checkpoint against the port's modules and cache it.

Depth models (PyTorch hub .pt, as torch.hub.load("intel-isl/MiDaS", ...)
downloads in the reference, depth_midas.py:10):

    python -m depth_estimation_tpu_torch.tools.import_weights <ckpt.pt> <model_type>

model_type ∈ {MiDaS_small, MiDaS, DPT_Large, DPT_Hybrid}; the cache is
keyed by the file's content hash, so a re-import is a no-op.
``DepthEstimator(model_type)`` then loads it when no weights are given.

The detector models' route (``--tflite``, MediaPipe .tflite files) is not
ported yet.
"""

import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "--tflite":
        print("import_weights --tflite: the .tflite route (MediaPipe detector weights) is not ported yet; "
              "it waits for ROADMAP queue A items 5-7.4", file=sys.stderr)
        return 2
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
