"""Samplers of the landmark stages and of the depth map (JAX ``ops/sampling.py``).

Half-pixel-centered bilinear crops from a box that depends on the data, as
gathers batched over images: the eye crops of the iris refinement
(``crop_resize_bilinear``) and the face crop of the mesh stage
(``crop_resize_bilinear_rect``). Images are (B, H, W, C) and boxes (B, k),
one box an image. The face crop's ``pixels`` maps gathered values to
float32, so a u8 BGR frame is sampled as the /255 RGB (``bgr_u8_to_rgb01``)
or /255 BGR (``u8_to_01``) frame without converting the whole frame.

Depth samplers, on the device with no host sync: ``depth_at_points``,
``iris_depth`` and the ROI medians (``masked_median``, ``roi_median_depth``,
``rois_median_depth``: every box in one masked sort). JAX's
``crop_resize_linear_matmul`` is the TPU's MXU form of the rect crop; the
gather form is the port's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


_INT32_MAX_F32 = 2147483520.0  # the largest float32 below 2**31


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Truncate to int32, clamped into its range first (a cast of a float
    outside it is undefined in torch)."""
    if not x.is_floating_point():
        return x.to(torch.int32)
    return torch.trunc(x).nan_to_num(0.0).clamp(-2.0 ** 31, _INT32_MAX_F32).to(torch.int32)


def u8_to_01(v: torch.Tensor) -> torch.Tensor:
    """Gathered u8 values → float32 in [0, 1], channels as they are: the
    detection program's BGR feed (JAX ``img_u8.astype(f32) / 255``)."""
    return v.to(torch.float32) / 255.0


def bgr_u8_to_rgb01(v: torch.Tensor) -> torch.Tensor:
    """Gathered u8 BGR values → RGB float32 in [0, 1], as the JAX frame
    program's ``img_u8[..., ::-1].astype(f32) / 255``."""
    return v.flip(-1).to(torch.float32) / 255.0


def _bilinear_gather(img, xi, xi1, yi, yi1, tx, ty, pixels: Optional[Callable]):
    """img (B, H, W, C); xi, xi1, tx (B, ow); yi, yi1, ty (B, oh) → (B, oh, ow, C),
    with the JAX function's order of operations."""
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    prep = pixels or (lambda v: v.to(torch.float32))

    def at(y, x):
        return prep(img[b, y[:, :, None], x[:, None, :]])

    txc, tyc = tx[:, None, :, None], ty[:, :, None, None]
    top = at(yi, xi) * (1 - txc) + at(yi, xi1) * txc
    bot = at(yi1, xi) * (1 - txc) + at(yi1, xi1) * txc
    return top * (1 - tyc) + bot * tyc


def _grid(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) + 0.5


def crop_resize_bilinear(img: torch.Tensor, box_xys: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Square crops: img (B, H, W, C), box_xys (B, 3) = (x0, y0, side) in
    pixels → (B, out_h, out_w, C), clamped at the image border."""
    h, w = img.shape[1], img.shape[2]
    out_h, out_w = out_hw
    x0, y0, side = box_xys[:, 0:1], box_xys[:, 1:2], box_xys[:, 2:3]
    xs = x0 + _grid(out_w, img.device) * (side / out_w) - 0.5
    ys = y0 + _grid(out_h, img.device) * (side / out_h) - 0.5
    xf = torch.clamp(torch.floor(xs), 0, w - 1)
    yf = torch.clamp(torch.floor(ys), 0, h - 1)
    tx = torch.clamp(xs - xf, 0.0, 1.0)
    ty = torch.clamp(ys - yf, 0.0, 1.0)
    xi, yi = xf.to(torch.int64), yf.to(torch.int64)
    return _bilinear_gather(img, xi, torch.clamp(xi + 1, max=w - 1), yi, torch.clamp(yi + 1, max=h - 1),
                            tx, ty, None)


def crop_resize_bilinear_rect(img: torch.Tensor, box_xywh: torch.Tensor, out_hw: Tuple[int, int],
                              pixels: Optional[Callable] = None) -> torch.Tensor:
    """Rectangular crops with crop-then-resize border semantics: img
    (B, H, W, C), box_xywh (B, 4) = (x0, y0, bw, bh), integer-valued, inside
    the image → (B, out_h, out_w, C). Sample coordinates clamp to the box, so
    the result is ``resize2d(img[y0:y0+bh, x0:x0+bw], out_hw, "linear")``."""
    out_h, out_w = out_hw
    x0, y0, bw, bh = (box_xywh[:, i:i + 1] for i in range(4))
    xs = x0 + torch.clamp(_grid(out_w, img.device) * (bw / out_w) - 0.5, min=0.0).minimum(bw - 1.0)
    ys = y0 + torch.clamp(_grid(out_h, img.device) * (bh / out_h) - 0.5, min=0.0).minimum(bh - 1.0)
    xf, yf = torch.floor(xs), torch.floor(ys)
    xi, yi = xf.to(torch.int64), yf.to(torch.int64)
    xi1 = torch.minimum(xi + 1, (x0 + bw - 1).to(torch.int64))
    yi1 = torch.minimum(yi + 1, (y0 + bh - 1).to(torch.int64))
    # a box inside the image needs no clamp; this one keeps a box that is not
    # (or not finite) from indexing out of range, a device-side assert on CUDA
    h, w = img.shape[1] - 1, img.shape[2] - 1
    xi, xi1, yi, yi1 = xi.clamp(0, w), xi1.clamp(0, w), yi.clamp(0, h), yi1.clamp(0, h)
    return _bilinear_gather(img, xi, xi1, yi, yi1, xs - xf, ys - yf, pixels)


# -- depth samplers ---------------------------------------------------------------------


def depth_at_points(depth: torch.Tensor, points_xy: torch.Tensor, faithful: bool = False) -> torch.Tensor:
    """depth (H, W), points_xy (N, 2) pixel (x, y) → (N,) samples at the
    truncated, clamped points: ``depth[y, x]``, or with ``faithful`` the
    reference's transposed ``depth[x, y]`` (face.py:106-107)."""
    h, w = depth.shape[-2], depth.shape[-1]
    px, py = to_int32(points_xy[:, 0]).long(), to_int32(points_xy[:, 1]).long()
    if faithful:
        return depth[px.clamp(0, h - 1), py.clamp(0, w - 1)]
    return depth[py.clamp(0, h - 1), px.clamp(0, w - 1)]


def iris_depth(depth: torch.Tensor, l_center_xy: torch.Tensor, r_center_xy: torch.Tensor) -> torch.Tensor:
    """Mean depth at the two iris centers, ``depth[y, x]`` indexing (the
    corrected form of face.py:91-110); a 0-d tensor on the device."""
    return depth_at_points(depth, torch.stack([l_center_xy, r_center_xy])).mean()


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The median of each row's ``values[mask]``, static shapes: values and
    mask (..., N) → (...,). Sort with a +inf fill, then average the middle
    two of the valid prefix (one value twice for an odd count); ``nan``
    for an empty mask."""
    v = torch.sort(torch.where(mask, values, torch.full((), float("inf"), dtype=values.dtype,
                                                        device=values.device)), dim=-1).values
    n = mask.sum(dim=-1, keepdim=True)
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0)
    hi = torch.div(n, 2, rounding_mode="floor")
    med = ((v.gather(-1, lo) + v.gather(-1, hi)) / 2.0)[..., 0]
    return torch.where(n[..., 0] > 0, med, torch.full((), float("nan"), dtype=med.dtype, device=med.device))


def _box_masks(h: int, w: int, boxes_yxyx: torch.Tensor) -> torch.Tensor:
    """(M, 4) pixel boxes (ymin, xmin, ymax, xmax) → (M, H·W) masks of the
    half-open boxes ``ymin <= y < ymax``, ``xmin <= x < xmax``."""
    ys = torch.arange(h, device=boxes_yxyx.device)[None, :, None]
    xs = torch.arange(w, device=boxes_yxyx.device)[None, None, :]
    b = boxes_yxyx[:, :, None, None]
    mask = (ys >= b[:, 0]) & (ys < b[:, 2]) & (xs >= b[:, 1]) & (xs < b[:, 3])
    return mask.reshape(boxes_yxyx.shape[0], h * w)


def roi_median_depth(depth: torch.Tensor, box_yxyx: torch.Tensor) -> torch.Tensor:
    """Median depth inside one (ymin, xmin, ymax, xmax) pixel box of depth
    (H, W); ``nan`` for an empty box."""
    return rois_median_depth(depth, box_yxyx[None], torch.ones(1, dtype=torch.bool, device=depth.device))[0]


def rois_median_depth(depth: torch.Tensor, boxes_yxyx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(M,) medians of depth (H, W) inside M pixel boxes (M, 4), all in one
    (M, H·W) masked sort on the depth map's device; invalid slots → nan."""
    h, w = depth.shape[-2], depth.shape[-1]
    boxes = torch.as_tensor(boxes_yxyx, device=depth.device)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=depth.device)
    flat = depth.reshape(1, h * w).expand(boxes.shape[0], h * w)
    meds = masked_median(flat, _box_masks(h, w, boxes))
    return torch.where(valid, meds, torch.full((), float("nan"), dtype=meds.dtype, device=meds.device))
