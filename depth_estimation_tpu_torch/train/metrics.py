"""Depth evaluation metrics (JAX ``train/metrics.py``).

The standard monocular-depth protocol over (B, H, W) DISPARITY maps:
per-image least-squares scale+shift alignment of the prediction to the
ground truth in disparity space (the closed form of the SSI loss,
``train/losses.py::_lstsq_scale_shift``), then the metrics in DEPTH space
(1/disparity): abs_rel, sq_rel, rmse, rmse_log, log10, δ<1.25^k. Masks mark
valid ground-truth pixels (gt_disp > eps).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from depth_estimation_tpu_torch.device import resolve_device
from depth_estimation_tpu_torch.train.losses import _lstsq_scale_shift

METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "d1", "d2", "d3")


def align_disparity(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image least-squares s·pred + t alignment to gt in disparity space."""
    mask = torch.ones_like(gt) if mask is None else mask.to(torch.float32)
    s, t = _lstsq_scale_shift(pred, gt, mask)
    return pred * s[:, None, None] + t[:, None, None]


def depth_metrics(pred_disp: torch.Tensor, gt_disp: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  align: bool = True, eps: float = 1e-6) -> Dict[str, torch.Tensor]:
    """Standard depth metrics over (B, H, W) disparity maps.

    Returns per-image means over valid pixels, averaged over the batch —
    each value an f32 scalar tensor. ``align=False`` scores the raw
    prediction (metric-calibrated models); ``align=True`` is the zero-shot
    protocol."""
    mask = (gt_disp > eps if mask is None else mask).to(torch.float32)
    if align:
        pred_disp = align_disparity(pred_disp, gt_disp, mask)
    # disparity → depth; clamp so aligned predictions crossing zero stay finite
    pred_d = 1.0 / pred_disp.clamp_min(eps)
    gt_d = 1.0 / gt_disp.clamp_min(eps)

    n = mask.sum(dim=(-2, -1)).clamp_min(1.0)

    def per_image_mean(x):
        return (x * mask).sum(dim=(-2, -1)) / n

    err = pred_d - gt_d
    abs_rel = per_image_mean(err.abs() / gt_d)
    sq_rel = per_image_mean(err * err / gt_d)
    rmse = per_image_mean(err * err).sqrt()
    log_err = pred_d.log() - gt_d.log()
    rmse_log = per_image_mean(log_err * log_err).sqrt()
    log10 = per_image_mean(log_err.abs() / np.log(10.0))
    ratio = torch.maximum(pred_d / gt_d, gt_d / pred_d)
    d1 = per_image_mean((ratio < 1.25).float())
    d2 = per_image_mean((ratio < 1.25 ** 2).float())
    d3 = per_image_mean((ratio < 1.25 ** 3).float())

    out = (abs_rel, sq_rel, rmse, rmse_log, log10, d1, d2, d3)
    return {k: v.mean() for k, v in zip(METRIC_NAMES, out)}


def metrics_to_host(m: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``depth_metrics``' values as floats, in one copy from the device."""
    values = torch.stack([m[k] for k in METRIC_NAMES]).cpu().tolist()
    return dict(zip(METRIC_NAMES, values))


def evaluate_pairs(apply_fn: Callable, pairs: Iterable[Tuple[np.ndarray, np.ndarray]], batch: int = 8,
                   align: bool = True, device="cuda") -> Dict[str, float]:
    """Score ``apply_fn(imgs_u8) -> (B, H, W) disparity`` over (image, gt)
    pairs; returns image-weighted mean metrics as plain floats.

    ``apply_fn`` takes a raw uint8 (B, H, W, 3) batch on ``device`` (such
    as ``train/data.py::TrainingApply``); the tail batch runs at its own
    size. Each batch's metrics come to the host in one copy."""
    dev = resolve_device(device)
    sums = {k: 0.0 for k in METRIC_NAMES}
    total = 0
    buf_img, buf_gt = [], []

    def flush():
        nonlocal total
        if not buf_img:
            return
        imgs = torch.from_numpy(np.stack(buf_img)).to(dev)
        gts = torch.from_numpy(np.stack(buf_gt)).to(dev)
        with torch.no_grad():
            m = metrics_to_host(depth_metrics(apply_fn(imgs), gts, align=align))
        for k in METRIC_NAMES:
            sums[k] += m[k] * len(buf_img)
        total += len(buf_img)
        buf_img.clear()
        buf_gt.clear()

    for img, gt in pairs:
        buf_img.append(img)
        buf_gt.append(gt)
        if len(buf_img) == batch:
            flush()
    flush()
    if total == 0:
        raise ValueError("no (image, disparity) pairs to evaluate")
    return {k: sums[k] / total for k in METRIC_NAMES} | {"images": total}
