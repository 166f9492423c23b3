"""Shared building blocks (JAX ``models/layers.py``), NCHW.

Convs of the EfficientNet-Lite and ResNetV2 encoders and of the MediaPipe
detector nets pad as TF's ``SAME`` does (``same_pads``): at stride 2 and an even size that is asymmetric, the
extra row and column at the bottom and right, which ``nn.Conv2d(padding=k//2)``
does not reproduce.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

LITE_BN_EPS = 1e-3  # the tf_efficientnet variants


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one axis: the output has
    ceil(size / stride) positions, and an odd total pads one more after."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, groups: int = 1, bias=None):
    """``F.conv2d`` with TF-SAME padding: symmetric pads go to the conv
    itself, asymmetric ones to one ``F.pad`` ahead of it."""
    (t, b), (l, r) = (same_pads(n, k, stride) for n, k in zip(x.shape[-2:], weight.shape[-2:]))
    if (t, l) == (b, r):
        return F.conv2d(x, weight, bias, stride, (t, l), groups=groups)
    return F.conv2d(F.pad(x, (l, r, t, b)), weight, bias, stride, groups=groups)


def max_pool3x3s2_same(x: torch.Tensor) -> torch.Tensor:
    """3×3/2 max pool with TF-SAME padding by −inf. Along an axis that pads
    (1, 1) this is ``padding=1``; along one that pads (0, 1) (an even size) it
    is ``ceil_mode``'s last window, which starts inside the input and ends one
    past it: one launch, no pad."""
    (t, _), (l, _) = (same_pads(n, 3, 2) for n in x.shape[-2:])
    return F.max_pool2d(x, 3, 2, (t, l), ceil_mode=True)


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d``'s parameters (no bias unless asked), TF-SAME padding in the forward."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride, groups=groups, bias=bias)

    def forward(self, x):
        return conv2d_same(x, self.weight, self.stride[0], self.groups, self.bias)


class FrozenBatchNorm2d(nn.Module):
    """Inference batch norm: y = (x - running_mean)·rsqrt(running_var + eps)·weight + bias.

    The four tensors are buffers with the hub's names, so the state dict is
    the hub's (without ``num_batches_tracked``, which the forward never
    reads). There is no training mode that updates the statistics. Outside a
    graph the forward is ``F.batch_norm`` in inference, one launch. They
    start at the identity (weight 1, bias 0, mean 0, var 1), as the JAX
    ``FrozenBatchNorm`` initializes.

    The JAX package holds all four as params, and its trainer updates and
    decays them like any other leaf (``train/step.py::trainable_tensors``
    makes them trainable here). ``F.batch_norm`` takes no gradient for the
    statistics, so when a gradient is wanted the forward is JAX's closed
    form, x·inv + (bias − mean·inv) with inv = weight / sqrt(var + eps)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        stats = (self.weight, self.bias, self.running_mean, self.running_var)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *stats)):
            inv = torch.reciprocal(torch.sqrt(self.running_var + self.eps)) * self.weight
            return x * inv[:, None, None] + (self.bias - self.running_mean * inv)[:, None, None]
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class DepthwiseSeparable(nn.Module):
    """geffnet DepthwiseSeparableConv: dw k×k (stride) + bn + ReLU6 → pw 1×1 + bn,
    residual when the stride is 1 and the channels match."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int):
        super().__init__()
        self.residual = stride == 1 and in_features == out_features
        self.conv_dw = Conv2dSame(in_features, in_features, kernel_size, stride, groups=in_features)
        self.bn1 = FrozenBatchNorm2d(in_features, LITE_BN_EPS)
        self.conv_pw = nn.Conv2d(in_features, out_features, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(out_features, LITE_BN_EPS)

    def forward(self, x):
        h = self.bn2(self.conv_pw(F.relu6(self.bn1(self.conv_dw(x)))))
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """geffnet InvertedResidual (MBConv without squeeze-excite, as in the Lite
    variants): pw-expand 1×1 + bn + ReLU6 → dw k×k (stride) + bn + ReLU6 →
    pw-project 1×1 + bn, residual when the stride is 1 and the channels match."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int, expand_ratio: int):
        super().__init__()
        mid = in_features * expand_ratio
        self.residual = stride == 1 and in_features == out_features
        self.conv_pw = nn.Conv2d(in_features, mid, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(mid, LITE_BN_EPS)
        self.conv_dw = Conv2dSame(mid, mid, kernel_size, stride, groups=mid)
        self.bn2 = FrozenBatchNorm2d(mid, LITE_BN_EPS)
        self.conv_pwl = nn.Conv2d(mid, out_features, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_features, LITE_BN_EPS)

    def forward(self, x):
        h = F.relu6(self.bn1(self.conv_pw(x)))
        h = F.relu6(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


# -- MediaPipe detector blocks (BlazeFace, FaceMesh, iris, BlazePose) ----------


class PReLU(nn.Module):
    """Per-channel parametric ReLU, the activation of MediaPipe's landmark
    graphs: one ``alpha`` a channel, initialized to 0.25. ``F.prelu`` is one
    kernel and computes max(0, x) + alpha·min(0, x), which is the JAX form's
    where(x ≥ 0, x, alpha·x) exactly (one of the two terms is 0)."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        return F.prelu(x, self.alpha)


def _shortcut(x: torch.Tensor, out_features: int, stride: int) -> torch.Tensor:
    """The residual branch: a 2×2/2 max pool at stride 2, then zero channels
    up to ``out_features``."""
    if stride == 2:
        x = F.max_pool2d(x, 2, 2)
    extra = out_features - x.shape[1]
    return F.pad(x, (0, 0, 0, 0, 0, extra)) if extra > 0 else x


class _DepthwiseBlock(nn.Module):
    """k×k depthwise (TF-SAME, stride) + 1×1 pointwise, plus the shortcut."""

    def __init__(self, in_features: int, out_features: int, stride: int, kernel_size: int):
        super().__init__()
        self.stride, self.out_features = stride, out_features
        self.conv_dw = Conv2dSame(in_features, in_features, kernel_size, stride, groups=in_features, bias=True)
        self.conv_pw = nn.Conv2d(in_features, out_features, 1)

    def residual_sum(self, x):
        return self.conv_pw(self.conv_dw(x)) + _shortcut(x, self.out_features, self.stride)


class MPBlock(_DepthwiseBlock):
    """MediaPipe landmark-net residual block (JAX layers.py:120): 3×3
    depthwise + 1×1 pointwise, shortcut, PReLU."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1, kernel_size: int = 3):
        super().__init__(in_features, out_features, stride, kernel_size)
        self.act = PReLU(out_features)

    def forward(self, x):
        return self.act(self.residual_sum(x))


class BlazeBlock(_DepthwiseBlock):
    """BlazeFace's block (JAX blazeface.py:23): 5×5 depthwise + 1×1
    pointwise, shortcut, ReLU."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1, kernel_size: int = 5):
        super().__init__(in_features, out_features, stride, kernel_size)

    def forward(self, x):
        return F.relu(self.residual_sum(x))


class IrisBlock(nn.Module):
    """The iris net's bottleneck block (JAX facemesh.py:95): 1×1 conv (2×2
    VALID at stride 2) to out/2 + PReLU → 3×3 depthwise → 1×1 expand, the
    shortcut, PReLU."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1):
        super().__init__()
        mid = out_features // 2
        self.stride, self.out_features = stride, out_features
        self.conv_squeeze = nn.Conv2d(in_features, mid, stride, stride)
        self.act_squeeze = PReLU(mid)
        self.conv_dw = nn.Conv2d(mid, mid, 3, padding=1, groups=mid)
        self.conv_expand = nn.Conv2d(mid, out_features, 1)
        self.act = PReLU(out_features)

    def forward(self, x):
        h = self.conv_expand(self.conv_dw(self.act_squeeze(self.conv_squeeze(x))))
        return self.act(h + _shortcut(x, self.out_features, self.stride))
