"""The torch.hub ``transforms`` surface.

The reference takes callables from ``torch.hub.load("intel-isl/MiDaS",
"transforms")`` and uses ``.dpt_transform`` / ``.small_transform``
(depth_midas.py:12-16). This module gives the same names as plain callables,
as the JAX package's ``transforms.py`` does:

    from depth_estimation_tpu_torch import transforms
    batch = transforms.dpt_transform(rgb_float_or_uint8_image)

Each takes an RGB numpy image (H, W, 3), u8 or float in [0, 1], and returns a
normalized float32 NHWC batch (1, h, w, 3) on ``device`` (the GPU unless the
caller names the CPU), computed by kernel K2.
"""

from __future__ import annotations

import numpy as np

from depth_estimation_tpu_torch.config import DEFAULT_PREPROCESS, DPT_PREPROCESS, SMALL_PREPROCESS
from depth_estimation_tpu_torch.ops.preprocess import preprocess


def _as_u8(img) -> np.ndarray:
    """The hub transforms take float RGB in [0, 1]; K2 takes u8: scale by
    255, clip and truncate, as the JAX package does."""
    img = np.asarray(img)
    return img if img.dtype == np.uint8 else np.clip(img * 255.0, 0, 255).astype(np.uint8)


def dpt_transform(img, device="cuda"):
    """384 'minimal' resize, mean = std = 0.5 (DPT_Large / DPT_Hybrid input)."""
    return preprocess(_as_u8(img), DPT_PREPROCESS, bgr_to_rgb=False, device=device)


def small_transform(img, device="cuda"):
    """256 'upper_bound' resize, ImageNet stats (MiDaS_small input)."""
    return preprocess(_as_u8(img), SMALL_PREPROCESS, bgr_to_rgb=False, device=device)


def default_transform(img, device="cuda"):
    """384 'upper_bound' resize, ImageNet stats: the hub's own pairing for
    the v2.1 "MiDaS" model. The reference never reaches it (its non-DPT
    branch selects small_transform, depth_midas.py:13-16), so it is here only
    for the hub surface."""
    return preprocess(_as_u8(img), DEFAULT_PREPROCESS, bgr_to_rgb=False, device=device)
