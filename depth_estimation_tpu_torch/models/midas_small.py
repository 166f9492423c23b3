"""MiDaS v2.1 small ("MiDaS_small"): EfficientNet-Lite3 encoder + feature-fusion
decoder, and the decoder blocks that DPT and MiDaS v2.1 share.

Counterpart of the JAX package's ``models/midas_small.py``, NCHW in and
(B, H, W) out. Module names follow the hub's ``MidasNet_small`` (features 64,
expand=True, non_negative=True): the encoder is ``pretrained.layer1-4``, the
decoder ``scratch.*``, so the port's ``state_dict`` is the hub's (without
``num_batches_tracked`` and the dead ``scratch.refinenet4.resConfUnit1``).
The fusion blocks upsample with align_corners=True, the head's
``output_conv.2`` with align_corners=False; when a gradient is wanted the
upsampling's backward is the interpolation matrices' adjoint
(``_Upsample2x``), so a train step gives the same gradient every call. The
depthwise, pointwise and decoder convs run as PyTorch gives them (cuDNN, or
ATen's depthwise kernel): none of them was ever a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from depth_estimation_tpu_torch.models.efficientnet_lite import EfficientNetLite3
from depth_estimation_tpu_torch.ops.kernels.resize import resize_planes_backward_plain

FEATURES = 64  # the hub's MidasNet_small


class _Upsample2x(torch.autograd.Function):
    """2× bilinear upsampling, ``F.interpolate``'s forward, with the adjoint
    of its interpolation matrices as the backward: Whᵀ·G·Ww on every plane,
    K3's backward (``resize_planes_backward_plain``, whose matrices stay on
    the device). ATen's CUDA backward scatters with atomic adds, so two
    identical train steps on the card gave different gradients; this one
    gives the same every call."""

    @staticmethod
    def forward(ctx, x, align_corners):
        h, w = x.shape[-2:]
        ctx.hw, ctx.align_corners = (h, w), align_corners
        return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=align_corners)

    @staticmethod
    def backward(ctx, grad):
        b, c, h2, w2 = grad.shape
        dx = resize_planes_backward_plain(grad.reshape(b * c, h2, w2), ctx.hw, "linear", ctx.align_corners)
        return dx.reshape(b, c, *ctx.hw).to(grad.dtype), None


def upsample2x(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Upsample2x.apply(x, align_corners)
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


class MidasSmall(nn.Module):
    def __init__(self):
        super().__init__()
        f = FEATURES
        self.pretrained = EfficientNetLite3()
        self.scratch = nn.Module()
        for i, c in enumerate((32, 48, 136, 384), start=1):
            self.scratch.add_module(f"layer{i}_rn", nn.Conv2d(c, f * 2 ** (i - 1), 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            self.scratch.add_module(
                f"refinenet{i}", FeatureFusionBlock(f * 2 ** (i - 1), expand=i != 1, align_corners=True, skip=i != 4))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1),
            nn.Identity(),  # the hub's Interpolate; UpsampleConv3x3 upsamples
            UpsampleConv3x3(f // 2, 32, align_corners=False),
            nn.ReLU(),
            nn.Conv2d(32, 1, 1),
            nn.ReLU(),
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
