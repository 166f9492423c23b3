"""Console entry: dataset evaluation with the standard depth metrics.

The port's ``depth-evaluate`` (JAX ``tools/evaluate.py``). Scores any
registry model over (image, disparity) pairs with the zero-shot MiDaS
protocol (per-image lstsq scale+shift alignment in disparity space, then
abs_rel / sq_rel / rmse / rmse_log / log10 / δ<1.25^k in depth space —
train/metrics.py). Weights come from the cache (``tools.import_weights``),
or are random from seed 0 when there are none.

Data: a directory of .npz files with ``image`` (H, W, 3) uint8 and
``disparity`` (H, W) float32 (train/data.py's storage format), or
``--synthetic N`` for a self-contained run. Each batch is K2, the network
and K3 from raw u8 (``train/data.py::TrainingApply``). Runs on ``cuda``
unless ``--device cpu``. Prints one JSON line of image-weighted mean metrics.

    python -m depth_estimation_tpu_torch.tools.evaluate (--data <npz_dir> | --synthetic N)
        [--hw H W] [--model-type MiDaS_small] [--batch 8] [--no-align] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import warnings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", help="directory of .npz (image, disparity) pairs")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="evaluate on N synthetic pairs instead of --data")
    ap.add_argument("--hw", type=int, nargs=2, default=(192, 256), metavar=("H", "W"),
                    help="synthetic pair size")
    ap.add_argument("--model-type", default="MiDaS_small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-align", action="store_true",
                    help="score raw predictions (metric-calibrated models)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)
    if not args.data and not args.synthetic:
        ap.error("one of --data / --synthetic is required")

    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.train.data import TrainingApply, iter_npz_dir, synthetic_pairs
    from depth_estimation_tpu_torch.train.metrics import evaluate_pairs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random-init warning is fine offline
        est = DepthEstimator(args.model_type, verbose=False, device=args.device)

    apply = TrainingApply(est.model, est.preprocess_cfg)
    pairs = (synthetic_pairs(args.synthetic, *args.hw) if args.synthetic
             else iter_npz_dir(args.data))
    with est._numerics():
        result = evaluate_pairs(apply, pairs, batch=args.batch, align=not args.no_align, device=est.device)
    print(json.dumps({"model_type": args.model_type,
                      "aligned": not args.no_align, **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
