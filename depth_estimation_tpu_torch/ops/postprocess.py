"""Depth-map → video-frame postprocessing with the reference's uint8
wrap-around (JAX ``ops/postprocess.py``).

* ``write_output`` (depth_midas.py:81-85): a raw ``astype(np.uint8)`` cast,
  no normalization, so float depth values alias mod 256;
* ``to_video_frame`` (midas_mediapipe.py:141-150): that cast, then ``*= 5``
  and ``+= 10`` in uint8 arithmetic (wrapping), then gray → 3 channels;
  ``to_video_frame_u8`` is its device form, less the 3-channel merge;
* ``side_by_side`` (midas_mediapipe.py:152-155): two half-size frames.
"""

from __future__ import annotations

import numpy as np
import torch


def wraparound_u8(x: torch.Tensor) -> torch.Tensor:
    """numpy ``astype(np.uint8)`` semantics for float inputs, on the tensor's
    device: truncate toward zero, then wrap mod 256.

    torch's float→uint8 cast is not defined outside [0, 255], so the wrap is
    spelled out: exact for |trunc(x)| < 2**24 (the f32 integer range)."""
    t = torch.trunc(x.to(torch.float32))
    t = t - 256.0 * torch.floor(t / 256.0)
    return t.to(torch.uint8)


def depth_to_gray_u8(depth: np.ndarray, faithful: bool = True) -> np.ndarray:
    """float depth → uint8 gray. Faithful: bare cast with wraparound."""
    if faithful:
        return depth.astype(np.uint8)
    lo, hi = float(depth.min()), float(depth.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return ((depth - lo) * scale).astype(np.uint8)


def merge_gray3(gray_u8: np.ndarray) -> np.ndarray:
    """gray HxW → HxWx3 (cv2.merge([g,g,g]) equivalent, depth_midas.py:84)."""
    return np.repeat(gray_u8[..., None], 3, axis=-1)


def to_video_frame_u8(depth: torch.Tensor) -> torch.Tensor:
    """``to_video_frame`` on the device, without the 3-channel
    merge: (…, H, W) float → uint8, ``*5 + 10`` in uint8 arithmetic, which
    wraps in torch as in numpy (JAX ``to_video_frame_u8_jax``)."""
    return wraparound_u8(depth) * 5 + 10


def to_video_frame(depth: np.ndarray) -> np.ndarray:
    """midas_mediapipe.py:141-150 on the host (uint8 wrap-around kept)."""
    out = depth.astype(np.uint8)
    out *= 5  # uint8 arithmetic — wraps, as in the reference
    out += 10
    return merge_gray3(out)


def side_by_side(img1: np.ndarray, img2: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Two frames at half of (out_w, out_h), side by side
    (midas_mediapipe.py:152-155; cv2.resize's default bilinear)."""
    import cv2

    f1 = cv2.resize(img1, (out_w // 2, out_h // 2))
    f2 = cv2.resize(img2, (out_w // 2, out_h // 2))
    return np.hstack((f1, f2))
