"""SSD anchors, box decoding and NMS of the BlazeFace and BlazePose
detectors (JAX ``detect/anchors.py``).

The anchors are host numpy. Decode and NMS are fixed-shape tensor functions
over any leading batch dimensions, so that they run inside the fused frame
program on the device with no host round trip: NMS over BlazeFace's 896
anchors (BlazePose's 2254) is an O(N²) masked matrix computation, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    input_size: int = 128
    # (feature_map_size, anchors_per_cell) per detection head
    heads: Tuple[Tuple[int, int], ...] = ((16, 2), (8, 6))


BLAZEFACE_FRONT = AnchorConfig()
# pose_detection_cpu.pbtxt SsdAnchorsCalculator: strides (8, 16, 32, 32, 32),
# aspect 1.0 + interpolated scale → 2 anchors a cell at strides 8 and 16, and
# 6 a cell on the 7×7 grid the three stride-32 layers share:
# 28²·2 + 14²·2 + 7²·6 = 2254 anchors
BLAZEPOSE_DETECTOR = AnchorConfig(input_size=224, heads=((28, 2), (14, 2), (7, 6)))


def build_anchors(cfg: AnchorConfig) -> np.ndarray:
    """(N, 4) anchors as (x_center, y_center, w, h) in [0, 1] units, ordered
    by head, then y, x, then per cell. MediaPipe's front-camera configs
    collapse to unit-size anchors at cell centers (fixed_anchor_size=true)."""
    anchors = []
    for fm, per_cell in cfg.heads:
        for y in range(fm):
            for x in range(fm):
                cx = (x + 0.5) / fm
                cy = (y + 0.5) / fm
                for _ in range(per_cell):
                    anchors.append((cx, cy, 1.0, 1.0))
    return np.asarray(anchors, dtype=np.float32)


def decode_boxes(raw: torch.Tensor, anchors: torch.Tensor, scale: float) -> torch.Tensor:
    """Raw SSD regressions (..., N, 4 + 2K) = (dx, dy, w, h, K keypoints × (x, y))
    → (ymin, xmin, ymax, xmax, keypoints...) in [0, 1] image units
    (MediaPipe's decode with x/y/w/h_scale = input size and unit anchors)."""
    # the centers and keypoints as (x, y) pairs, each x·aw + ax and y·ah + ay
    pts = raw[..., [0, 1, *range(4, raw.shape[-1])]].unflatten(-1, (-1, 2))
    pts = pts / scale * anchors[..., None, 2:4] + anchors[..., None, 0:2]
    half = raw[..., 2:4] / scale * anchors[..., 2:4] / 2.0  # (w/2, h/2)
    center = pts[..., 0, :]
    corners = torch.cat([center - half, center + half], dim=-1)[..., [1, 0, 3, 2]]  # ymin, xmin, ymax, xmax
    return torch.cat([corners, pts[..., 1:, :].flatten(-2)], dim=-1)


def decode_scores(logits: torch.Tensor, clip: float = 100.0) -> torch.Tensor:
    """MediaPipe clips logits to ±100 before the sigmoid."""
    return torch.reciprocal(1.0 + torch.exp(-torch.clamp(logits, -clip, clip)))


def _area(b: torch.Tensor) -> torch.Tensor:
    return torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, N) IoU of (ymin, xmin, ymax, xmax) boxes a (..., M, ≥4) and b (..., N, ≥4)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    iy = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0)
    ix = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0)
    inter = iy * ix
    return inter / torch.clamp(_area(a) + _area(b) - inter, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.3,
        score_threshold: float = 0.5, max_outputs: int = 16):
    """Hard NMS over a fixed anchor set, branch-free: boxes (..., N, D),
    scores (..., N) → (boxes (..., M, D), scores (..., M), valid (..., M)
    bool) with M = ``max_outputs``; invalid slots have score 0.

    Kept candidates come in order of falling score, equal scores by anchor
    index: the sort is stable, as ``jnp.argsort`` is (a plain sort may
    reorder equal scores on CUDA, and then the face that gets cropped,
    ``boxes[..., 0, :]``, changes)."""
    n = scores.shape[-1]
    score_mask = scores >= score_threshold
    s = torch.where(score_mask, scores, -1.0)
    idx = torch.arange(n, device=scores.device)
    si, sj = s[..., :, None], s[..., None, :]
    # suppressed[i] if a higher-ranked candidate j overlaps i beyond the threshold
    higher = (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None]))
    suppressed = ((_iou(boxes, boxes) > iou_threshold) & higher & score_mask[..., None, :]).any(dim=-1)
    s_kept = torch.where(score_mask & ~suppressed, scores, -1.0)
    order = torch.argsort(-s_kept, dim=-1, stable=True)[..., :max_outputs]
    top = torch.gather(s_kept, -1, order)
    kept = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    return kept, torch.clamp(top, min=0.0), top > 0


def weighted_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.3,
                 score_threshold: float = 0.5, max_outputs: int = 16):
    """MediaPipe-style blending NMS: each kept detection is the
    score-weighted average of all candidates overlapping it above the IoU
    threshold. Same shapes as ``nms``."""
    kept, kept_scores, valid = nms(boxes, scores, iou_threshold, score_threshold, max_outputs)
    for_blend = torch.where(scores >= score_threshold, scores, 0.0)
    w = torch.where(_iou(kept, boxes) > iou_threshold, for_blend[..., None, :], 0.0)  # (..., M, N)
    blended = (w @ boxes) / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return torch.where(valid[..., None], blended, 0.0), kept_scores, valid
