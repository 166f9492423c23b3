"""The MiDaS decoder blocks that DPT and MiDaS v2.1 share (JAX ``models/midas_small.py``).

Only what ``models/dpt.py`` and ``models/midas_v21.py`` import is ported so
far: ``upsample2x``, ``ResidualConvUnit``, ``FeatureFusionBlock`` and
``UpsampleConv3x3``. NCHW, hub module names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def upsample2x(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=align_corners)


class UpsampleConv3x3(nn.Conv2d):
    """``conv3x3_SAME(2x bilinear upsample(x))``, computed literally, with
    ``nn.Conv2d``'s parameters (the head's ``output_conv.2``)."""

    def __init__(self, in_channels: int, features: int, align_corners: bool = False):
        super().__init__(in_channels, features, 3, padding=1)
        self.align_corners = align_corners

    def forward(self, x):
        return super().forward(upsample2x(x, self.align_corners))


class ResidualConvUnit(nn.Module):
    """MiDaS ResidualConvUnit_custom (bn=False): relu→conv→relu→conv + x."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.relu(x))
        return self.conv2(F.relu(h)) + x


class FeatureFusionBlock(nn.Module):
    """MiDaS FeatureFusionBlock_custom (deconv=False, bn=False).

    The reference upsamples and then applies the 1×1 ``out_conv``; a 1×1
    conv (channels) and the bilinear resize (space) commute exactly, so the
    conv runs first, on a quarter of the pixels, as in the JAX package."""

    def __init__(self, features: int, expand: bool = False, align_corners: bool = True,
                 skip: bool = True):
        super().__init__()
        self.align_corners = align_corners
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features // 2 if expand else features, 1)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        h = x
        if skip is not None:
            h = h + self.resConfUnit1(skip)
        h = self.out_conv(self.resConfUnit2(h))
        return upsample2x(h, self.align_corners)
