"""MiDaS v2.1 Large ("MiDaS"): ResNeXt-101 32x8d encoder + v2.1 fusion decoder.

Counterpart of the JAX package's ``models/midas_v21.py``, NCHW in and
(B, H, W) out. Module names follow the hub's ``MidasNet``: the torchvision
stem sits inside ``pretrained.layer1`` as Sequential[conv1, bn1, relu,
maxpool, blocks], so layer 1's blocks are ``pretrained.layer1.4.{i}`` and
layers 2–4 are ``pretrained.layer{2,3,4}.{i}``; the decoder is ``scratch.*``.
The port's ``state_dict`` is the hub's (without ``num_batches_tracked`` and
the dead ``scratch.refinenet4.resConfUnit1``).

The grouped 3×3 conv2 of a bottleneck has one route here. The JAX
package's ``conv2_impl`` picks among five TPU lowerings of the same
function over one parameter tree (tests/test_midas_v21.py shows they agree);
it is not carried over. Stride-1 conv2s launch kernel K4
(``ops/kernels/grouped_conv.py``) in f32 and in bf16; the three strided
conv2s (block 0 of layers 2–4) are ``F.conv2d(stride=2, groups=G)``: the TPU
kernel is stride-1 only and the JAX package computes them outside it too.
Every other conv (stem, 1×1s, ``layerX_rn``, decoder, head) is a plain
``nn.Conv2d``, as none of them was ever a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from depth_estimation_tpu_torch.models.layers import FrozenBatchNorm2d
from depth_estimation_tpu_torch.models.midas_small import ResidualConvUnit, UpsampleConv3x3, upsample2x
from depth_estimation_tpu_torch.ops.kernels.grouped_conv import grouped_conv3x3

BN_EPS = 1e-5  # torchvision ResNet default


@dataclasses.dataclass(frozen=True)
class MidasV21Config:
    """Full size matches hub MidasNet exactly; tests shrink every axis."""

    depths: Tuple[int, int, int, int] = (3, 4, 23, 3)
    planes: Tuple[int, int, int, int] = (64, 128, 256, 512)
    stem_features: int = 64
    groups: int = 32
    width_per_group: int = 8
    expansion: int = 4
    features: int = 256  # decoder width
    head_features: int = 128
    head_mid: int = 32
    non_negative: bool = True

    def width(self, planes: int) -> int:
        """Grouped-conv width of a bottleneck (torchvision formula)."""
        return int(planes * self.width_per_group / 64) * self.groups


MIDAS_V21 = MidasV21Config()


class GroupedConv3x3(nn.Conv2d):
    """The bottleneck's conv2 with ``nn.Conv2d(groups=G)``'s parameter:
    K4 at stride 1, ``F.conv2d`` at stride 2."""

    def __init__(self, width: int, groups: int, stride: int):
        super().__init__(width, width, 3, stride=stride, padding=1, groups=groups, bias=False)

    def forward(self, x):
        if self.stride == (1, 1):
            return grouped_conv3x3(x, self.weight, self.groups)
        return super().forward(x)


class ResNeXtBottleneck(nn.Module):
    """torchvision Bottleneck with a grouped 3×3 (stride on conv2)."""

    def __init__(self, in_features: int, width: int, out_features: int, stride: int, groups: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width, BN_EPS)
        self.conv2 = GroupedConv3x3(width, groups, stride)
        self.bn2 = FrozenBatchNorm2d(width, BN_EPS)
        self.conv3 = nn.Conv2d(width, out_features, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_features, BN_EPS)
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_features, out_features, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(out_features, BN_EPS))
        else:
            self.downsample = None

    def forward(self, x):
        sc = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + sc)


class ResNeXt(nn.Module):
    """The backbone as MidasNet wraps it: ``layer1`` carries the stem."""

    def __init__(self, cfg: MidasV21Config = MIDAS_V21):
        super().__init__()
        in_c = cfg.stem_features
        for li, (depth, planes) in enumerate(zip(cfg.depths, cfg.planes), start=1):
            out_c, width = planes * cfg.expansion, cfg.width(planes)
            blocks = []
            for bi in range(depth):
                stride = 2 if li > 1 and bi == 0 else 1
                blocks.append(ResNeXtBottleneck(in_c, width, out_c, stride, cfg.groups, bi == 0))
                in_c = out_c
            layer = nn.Sequential(*blocks)
            if li == 1:
                layer = nn.Sequential(
                    nn.Conv2d(3, cfg.stem_features, 7, stride=2, padding=3, bias=False),
                    FrozenBatchNorm2d(cfg.stem_features, BN_EPS),
                    nn.ReLU(),
                    nn.MaxPool2d(3, stride=2, padding=1),
                    layer,
                )
            self.add_module(f"layer{li}", layer)

    def forward(self, x):
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l1, l2, l3, self.layer4(l3)


class FeatureFusionBlockV21(nn.Module):
    """v2.1 FeatureFusionBlock: no out-projection, align_corners=True 2× up."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        h = x
        if skip is not None:
            h = h + self.resConfUnit1(skip)
        return upsample2x(self.resConfUnit2(h), align_corners=True)


class MidasV21(nn.Module):
    def __init__(self, cfg: MidasV21Config = MIDAS_V21):
        super().__init__()
        self.cfg = cfg
        f = cfg.features
        self.pretrained = ResNeXt(cfg)
        self.scratch = nn.Module()
        for i, planes in enumerate(cfg.planes, start=1):
            self.scratch.add_module(f"layer{i}_rn", nn.Conv2d(planes * cfg.expansion, f, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlockV21(f, skip=i != 4))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(f, cfg.head_features, 3, padding=1),
            nn.Identity(),  # the hub's Interpolate; UpsampleConv3x3 upsamples
            UpsampleConv3x3(cfg.head_features, cfg.head_mid, align_corners=False),
            nn.ReLU(),
            nn.Conv2d(cfg.head_mid, 1, 1),
            nn.ReLU() if cfg.non_negative else nn.Identity(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) normalized, H and W multiples of 32 → (B, H, W)."""
        s = self.scratch
        l1, l2, l3, l4 = self.pretrained(x)
        p4 = s.refinenet4(s.layer4_rn(l4))
        p3 = s.refinenet3(p4, s.layer3_rn(l3))
        p2 = s.refinenet2(p3, s.layer2_rn(l2))
        p1 = s.refinenet1(p2, s.layer1_rn(l1))
        return s.output_conv(p1)[:, 0]
