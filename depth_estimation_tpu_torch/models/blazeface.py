"""BlazeFace short-range face detector (JAX ``models/blazeface.py``), NCHW.

MediaPipe's face_detection_front model: a 128×128 input, 5×5 depthwise
BlazeBlocks, and SSD heads on the 16×16 map (2 anchors a cell) and the 8×8
map (6 a cell): 896 anchors × (1 score + 16 box and keypoint regressions).
Module names are the Flax module names, so ``utils/convert.py`` maps the
JAX parameter tree key for key. Decode and NMS are ``detect/anchors.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from depth_estimation_tpu_torch.models.layers import BlazeBlock, Conv2dSame

WIDTHS_16 = (24, 28, 32, 36, 42, 48, 56, 64, 72, 80, 88)
STRIDE2_AT_16 = (2, 5)
WIDTHS_8 = (96, 96, 96, 96, 96)


def ssd_head(conv: nn.Conv2d, fm: torch.Tensor, values: int) -> torch.Tensor:
    """A 1×1 head's output in the anchors' order (y, x, then per cell): the
    NHWC reshape of the JAX head, so NCHW is permuted to (B, H, W, C) first."""
    out = conv(fm).permute(0, 2, 3, 1)
    return out.reshape(out.shape[0], -1, values) if values > 1 else out.reshape(out.shape[0], -1)


class BlazeFace(nn.Module):
    """(B, 3, 128, 128) in [-1, 1] → (raw_boxes (B, 896, 16), raw_scores (B, 896))."""

    def __init__(self):
        super().__init__()
        self.stem = Conv2dSame(3, 24, 5, 2, bias=True)
        self.names_16, self.names_8 = [], []
        c = 24
        for i, w in enumerate(WIDTHS_16):
            self.add_module(f"blaze_{i}", BlazeBlock(c, w, 2 if i in STRIDE2_AT_16 else 1))
            self.names_16.append(f"blaze_{i}")
            c = w
        for i, w in enumerate(WIDTHS_8):
            self.add_module(f"blaze2_{i}", BlazeBlock(c, w, 2 if i == 0 else 1))
            self.names_8.append(f"blaze2_{i}")
            c = w
        self.classifier_16 = nn.Conv2d(WIDTHS_16[-1], 2, 1)
        self.classifier_8 = nn.Conv2d(WIDTHS_8[-1], 6, 1)
        self.regressor_16 = nn.Conv2d(WIDTHS_16[-1], 2 * 16, 1)
        self.regressor_8 = nn.Conv2d(WIDTHS_8[-1], 6 * 16, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.stem(x))
        for name in self.names_16:
            h = getattr(self, name)(h)
        f16 = h  # (B, 88, 16, 16)
        for name in self.names_8:
            h = getattr(self, name)(h)
        f8 = h  # (B, 96, 8, 8)
        scores = torch.cat([ssd_head(self.classifier_16, f16, 1), ssd_head(self.classifier_8, f8, 1)], dim=1)
        boxes = torch.cat([ssd_head(self.regressor_16, f16, 16), ssd_head(self.regressor_8, f8, 16)], dim=1)
        return boxes, scores
