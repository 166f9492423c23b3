"""Depth training losses (JAX ``train/losses.py``), over (B, H, W) disparity maps.

* ``ssi_loss`` — scale-and-shift-invariant MAE: per-image least-squares
  (s, t) alignment of the prediction to ground truth in disparity space,
  then trimmed absolute error (MiDaS paper's ρ_ssitrim with trim=0.2).
* ``gradient_matching_loss`` — multi-scale gradient matching regularizer.

They compute what the JAX package computes, gradients through s and t
included. The trim's cut is ``jnp.quantile``'s default linear interpolation
between two order statistics of each image, taken with ``torch.kthvalue``:
``torch.quantile`` refuses more than 2^24 values, a batch of 86 at DPT's
384×512.
"""

from __future__ import annotations

from typing import Optional

import torch


def _lstsq_scale_shift(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """Closed-form per-image least squares: min_{s,t} ||s·pred + t - gt||²_mask."""
    n = mask.sum(dim=(-2, -1)).clamp_min(1.0)
    sp = (pred * mask).sum(dim=(-2, -1))
    sg = (gt * mask).sum(dim=(-2, -1))
    spp = (pred * pred * mask).sum(dim=(-2, -1))
    spg = (pred * gt * mask).sum(dim=(-2, -1))
    det = spp * n - sp * sp
    det = torch.where(det.abs() < 1e-6, torch.full_like(det, 1e-6), det)
    s = (spg * n - sp * sg) / det
    t = (spp * sg - sp * spg) / det
    return s, t


def _row_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=1, keepdims=True)`` (linear) of a (B, N) tensor."""
    n = x.shape[1]
    pos = torch.tensor(q, dtype=x.dtype) * (n - 1)
    low, high = int(torch.floor(pos)), int(torch.ceil(pos))
    high_weight = pos - low
    low_value = torch.kthvalue(x, min(max(low, 0), n - 1) + 1, dim=1, keepdim=True).values
    high_value = torch.kthvalue(x, min(max(high, 0), n - 1) + 1, dim=1, keepdim=True).values
    return low_value * (1 - high_weight) + high_value * high_weight


def ssi_loss(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None,
             trim: float = 0.2) -> torch.Tensor:
    """Scale-shift-invariant trimmed MAE over (B, H, W) disparity maps."""
    mask = torch.ones_like(gt) if mask is None else mask.to(torch.float32)
    s, t = _lstsq_scale_shift(pred, gt, mask)
    aligned = pred * s[:, None, None] + t[:, None, None]
    err = (aligned - gt).abs() * mask
    if trim > 0:
        # trim the largest `trim` fraction of residuals per image
        b = err.shape[0]
        flat = err.reshape(b, -1)
        cut = _row_quantile(flat.detach(), 1.0 - trim)
        flat = torch.where(flat <= cut, flat, torch.zeros_like(flat))
        denom = (mask.reshape(b, -1).sum(dim=1) * (1.0 - trim)).clamp_min(1.0)
        return (flat.sum(dim=1) / denom).mean()
    denom = mask.sum(dim=(-2, -1)).clamp_min(1.0)
    return (err.sum(dim=(-2, -1)) / denom).mean()


def gradient_matching_loss(pred: torch.Tensor, gt: torch.Tensor, scales: int = 4) -> torch.Tensor:
    """Multi-scale gradient matching term (MiDaS R_reg)."""
    total = 0.0
    p, g = pred, gt
    for _ in range(scales):
        diff = p - g
        gx = (diff[..., :, 1:] - diff[..., :, :-1]).abs().mean()
        gy = (diff[..., 1:, :] - diff[..., :-1, :]).abs().mean()
        total = total + gx + gy
        p = p[..., ::2, ::2]
        g = g[..., ::2, ::2]
    return total / scales
