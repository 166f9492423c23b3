"""Separable image resize as a pair of interpolation matrices.

Interpolation is linear in the input, so a fixed (in_size → out_size) resize
is one dense matrix per axis. Both cv2 ``INTER_CUBIC`` and torch ``bicubic``
use the Keys cubic kernel with A = -0.75 and half-pixel source mapping, with
replicated borders; ``interp_matrix`` builds that matrix on the host, a copy
of the JAX package's numpy code so that both packages use the same numbers.

``resize2d`` is the plain PyTorch version: two ``einsum`` contractions, in
the JAX package's layout ((…, H, W, C) or (H, W)).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from depth_estimation_tpu_torch.device import at_least_f32

_CUBIC_A = -0.75  # Keys kernel sharpness used by OpenCV and PyTorch


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Keys cubic weights for fractional offsets ``t`` in [0,1): the 4 taps
    at source offsets -1, 0, +1, +2 per output sample."""
    A = _CUBIC_A
    d = np.stack([1.0 + t, t, 1.0 - t, 2.0 - t], axis=-1)

    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0,
            ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0,
            np.where(x < 2.0, ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A, 0.0),
        )

    return k(d)


def _linear_weights(t: np.ndarray) -> np.ndarray:
    """Two-tap linear weights for fractional offsets ``t`` (taps at 0, +1)."""
    return np.stack([1.0 - t, t], axis=-1)


@functools.lru_cache(maxsize=256)
def _interp_matrix_cached(
    in_size: int, out_size: int, method: str, align_corners: bool
) -> np.ndarray:
    if method not in ("cubic", "linear", "nearest"):
        raise ValueError(f"unknown interpolation method {method!r}")

    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = 0.0 if out_size == 1 else (in_size - 1) / (out_size - 1)
        src = dst * scale
    else:
        scale = in_size / out_size
        src = (dst + 0.5) * scale - 0.5

    W = np.zeros((out_size, in_size), dtype=np.float64)
    if method == "nearest":
        # torch 'nearest' uses floor(dst * in/out)
        idx = np.clip((dst * (in_size / out_size)).astype(np.int64), 0, in_size - 1)
        W[np.arange(out_size), idx] = 1.0
        return W.astype(np.float32)

    base = np.floor(src).astype(np.int64)
    t = src - base
    if method == "cubic":
        taps = _cubic_weights(t)  # (out, 4)
        offsets = np.arange(-1, 3)
    else:
        taps = _linear_weights(t)  # (out, 2)
        offsets = np.arange(0, 2)

    for j, off in enumerate(offsets):
        cols = np.clip(base + off, 0, in_size - 1)  # replicate borders
        np.add.at(W, (np.arange(out_size), cols), taps[:, j])
    return W.astype(np.float32)


def interp_matrix(
    in_size: int, out_size: int, method: str = "cubic", align_corners: bool = False
) -> np.ndarray:
    """Dense (out_size, in_size) float32 interpolation matrix. Host-side, cached."""
    return _interp_matrix_cached(int(in_size), int(out_size), method, bool(align_corners))


def _matrix(in_size, out_size, method, align_corners, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(interp_matrix(in_size, out_size, method, align_corners)).to(device, dtype)


def resize2d(
    img: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "cubic",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize the two spatial dims of ``img`` (…, H, W, C) or (H, W).

    Spatial dims are the last two when ``img.ndim == 2``, otherwise dims -3
    and -2 (NHWC / HWC). Computes in float32 (float64 for a float64 input)
    and casts back to a floating input's dtype."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    squeeze2d = img.ndim == 2
    if squeeze2d:
        img = img[..., None]
    in_h, in_w = img.shape[-3], img.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return img[..., 0] if squeeze2d else img

    dtype = img.dtype
    x = at_least_f32(img)
    if in_h != out_h:
        x = torch.einsum("oh,...hwc->...owc", _matrix(in_h, out_h, method, align_corners, x.device, x.dtype), x)
    if in_w != out_w:
        x = torch.einsum("ow,...hwc->...hoc", _matrix(in_w, out_w, method, align_corners, x.device, x.dtype), x)
    if dtype.is_floating_point:
        x = x.to(dtype)
    return x[..., 0] if squeeze2d else x


def resize_bicubic(img, out_hw, align_corners: bool = False):
    """torch ``F.interpolate(mode='bicubic')`` / cv2 ``INTER_CUBIC`` equivalent
    (reference: depth_midas.py:28-33)."""
    return resize2d(img, out_hw, method="cubic", align_corners=align_corners)


def resize_bilinear(img, out_hw, align_corners: bool = True):
    """torch ``F.interpolate(mode='bilinear')`` equivalent."""
    return resize2d(img, out_hw, method="linear", align_corners=align_corners)
