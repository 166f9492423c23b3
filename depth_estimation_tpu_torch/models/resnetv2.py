"""ResNetV2 (BiT) stem of the DPT_Hybrid backbone, NCHW.

Counterpart of the JAX package's ``models/resnetv2.py``: timm's
``vit_base_r50_s16_384`` backbone, ResNetV2 with stages (3, 4, 9),
``preact=False`` and the 'same' stem: weight-standardized convs with TF-SAME
padding, GroupNorm(32) + ReLU after each conv, non-preact bottlenecks with a
conv + norm downsample branch and a ReLU after the add. Module names follow
timm (``stem.conv``, ``stem.norm``, ``stages.{s}.blocks.{b}.{conv1..3,
norm1..3, downsample.conv, downsample.norm}``), so the hub's keys under
``pretrained.model.patch_embed.backbone`` load as they are.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from depth_estimation_tpu_torch.models.layers import conv2d_same, max_pool3x3s2_same

STAGE_DEPTHS = (3, 4, 9)
STAGE_CHANNELS = (256, 512, 1024)
STEM_FEATURES = 64
STD_EPS = 1e-6  # timm StdConv2dSame


def standardize(weight: torch.Tensor) -> torch.Tensor:
    """Each output channel's kernel less its mean, over the square root of its
    population variance (ddof 0) plus 1e-6, over (I, kH, kW); in f32. One
    batch norm in training mode over the flattened kernel, as timm does it."""
    w = weight.float()
    std = F.batch_norm(w.reshape(1, w.shape[0], -1), None, None, training=True, momentum=0.0, eps=STD_EPS)
    return std.reshape_as(w).to(weight.dtype)


class StdConv(nn.Conv2d):
    """timm ``StdConv2dSame``: a weight-standardized conv with TF-SAME padding.

    ``weight`` holds the hub's raw kernel, so the ``state_dict`` is the hub's;
    each forward standardizes it, as the JAX package does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride, bias=False)

    def forward(self, x):
        return conv2d_same(x, standardize(self.weight), self.stride[0])


class GroupNormAct(nn.GroupNorm):
    """timm ``GroupNormAct``: GroupNorm(32 groups, eps 1e-5), then ReLU if ``act``."""

    def __init__(self, channels: int, act: bool = True):
        super().__init__(32, channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        h = F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        return F.relu(h) if self.act else h


class Bottleneck(nn.Module):
    """Non-preact ResNetV2 bottleneck; the stride is on conv2."""

    def __init__(self, in_features: int, out_features: int, stride: int, downsample: bool):
        super().__init__()
        mid = out_features // 4
        self.downsample = nn.Sequential(OrderedDict(
            conv=StdConv(in_features, out_features, 1, stride),
            norm=GroupNormAct(out_features, act=False))) if downsample else None
        self.conv1 = StdConv(in_features, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv(mid, out_features, 1)
        self.norm3 = GroupNormAct(out_features, act=False)

    def forward(self, x):
        sc = x if self.downsample is None else self.downsample(x)
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + sc)


class Stage(nn.Module):
    def __init__(self, in_features: int, out_features: int, depth: int, stride: int):
        super().__init__()
        self.blocks = nn.Sequential(*(
            Bottleneck(in_features if bi == 0 else out_features, out_features, stride if bi == 0 else 1, bi == 0)
            for bi in range(depth)))

    def forward(self, x):
        return self.blocks(x)


class Stem(nn.Module):
    """7×7/2 standardized conv, GroupNorm + ReLU, 3×3/2 max pool (TF-SAME, −inf pads)."""

    def __init__(self):
        super().__init__()
        self.conv = StdConv(3, STEM_FEATURES, 7, 2)
        self.norm = GroupNormAct(STEM_FEATURES)

    def forward(self, x):
        return max_pool3x3s2_same(self.norm(self.conv(x)))


class ResNetV2Stem(nn.Module):
    """x (B, 3, H, W) → (stage 3's output (1024 ch, stride 16), [stage 1's
    (256 ch, stride 4), stage 2's (512 ch, stride 8)])."""

    def __init__(self):
        super().__init__()
        self.stem = Stem()
        in_c, stages = STEM_FEATURES, []
        for si, (depth, c) in enumerate(zip(STAGE_DEPTHS, STAGE_CHANNELS)):
            stages.append(Stage(in_c, c, depth, 1 if si == 0 else 2))
            in_c = c
        self.stages = nn.Sequential(*stages)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.stem(x)
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs[-1], outs[:-1]
