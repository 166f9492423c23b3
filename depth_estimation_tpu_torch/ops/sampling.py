"""Crop-and-resize samplers of the landmark stages (JAX ``ops/sampling.py``).

Half-pixel-centered bilinear crops from a box that depends on the data, as
gathers batched over images: the eye crops of the iris refinement
(``crop_resize_bilinear``) and the face crop of the mesh stage
(``crop_resize_bilinear_rect``). Images are (B, H, W, C) and boxes (B, k),
one box an image. The face crop's ``pixels`` maps gathered values to
float32, so a u8 BGR frame is sampled as the /255 RGB frame without
converting the whole frame.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


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
