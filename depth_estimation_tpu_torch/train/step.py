"""The train step (JAX ``train/step.py``): AdamW on every trainable tensor,
loss and gradient in one call.

``TrainState`` is the model, its ``torch.optim.AdamW`` and the step count.
The trainable tensors are the JAX package's param leaves: the module's
parameters and the four tensors of every frozen batch norm, which the JAX
package holds as params and updates and decays like any other leaf
(``trainable_tensors``). ``make_optimizer`` is ``optax.adamw``'s defaults
with no mask, p − lr·wd·p − lr·m̂/(√v̂ + eps), which is
``torch.optim.AdamW``'s rule.

The step runs under the frame program's f32 numerics (``device.full_f32``,
``device.conv_algorithms_by_timing``), so on the card it goes through the
kernels (K1, K2, K3, and K4 for MiDaS v2.1) and their autograd Functions.

``float64_gradients`` is the step's loss and gradients in float64 on the
CPU, the reference that f32 gradients, the card's and the CPU's, are held
against.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, full_f32
from depth_estimation_tpu_torch.models.layers import FrozenBatchNorm2d
from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess, resize_planes
from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
from depth_estimation_tpu_torch.train.losses import gradient_matching_loss, ssi_loss


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def trainable_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor the trainer updates, by state-dict name: the parameters
    and the frozen batch norms' buffers, each set to require grad. Call it
    after the model is on its device (moving a module replaces its
    buffers)."""
    params = dict(model.named_parameters())
    frozen = {f"{prefix}.{name}".lstrip(".") for prefix, mod in model.named_modules()
              if isinstance(mod, FrozenBatchNorm2d) for name, _ in mod.named_buffers(recurse=False)}
    out = {k: v for k, v in model.state_dict(keep_vars=True).items() if k in params or k in frozen}
    for t in out.values():
        t.requires_grad_(True)
    return out


def make_optimizer(model: nn.Module, lr: float = 1e-4, weight_decay: float = 1e-2) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)`` over ``trainable_tensors(model)``."""
    return torch.optim.AdamW(list(trainable_tensors(model).values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def loss_fn(model: nn.Module, images, gt_disparity, alpha: float = 0.5) -> torch.Tensor:
    pred = model(images)
    loss = ssi_loss(pred, gt_disparity)
    if alpha > 0:
        loss = loss + alpha * gradient_matching_loss(pred, gt_disparity)
    return loss


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, alpha: float = 0.5,
                    accum_steps: int = 1):
    """step(images, gt) -> the batch's loss (a detached scalar tensor), after
    one optimizer update. The gradients stay in each tensor's ``.grad``
    until the next step.

    ``accum_steps > 1`` splits the batch into that many equal microbatches,
    accumulates their gradients and averages them before the single update.
    Both losses are per-image means, so the average equals the full-batch
    gradient up to float association."""

    def step(images: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps={accum_steps}")
        with full_f32(), conv_algorithms_by_timing():
            optimizer.zero_grad(set_to_none=True)
            if accum_steps == 1:
                loss = loss_fn(model, images, gt, alpha)
                loss.backward()
            else:
                loss = torch.zeros((), device=gt.device)
                for im, g in zip(images.chunk(accum_steps), gt.chunk(accum_steps)):
                    micro = loss_fn(model, im, g, alpha)
                    (micro / accum_steps).backward()
                    loss = loss + micro.detach()
                loss = loss / accum_steps
            optimizer.step()
        return loss.detach()

    return step


def float64_gradients(apply: nn.Module, images: torch.Tensor, gt: torch.Tensor,
                      alpha: float = 0.5) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss and every trainable tensor's gradient of one step of
    ``apply`` (a ``train.data.TrainingApply``) on a u8 batch, in float64 on
    the CPU: a float64 copy of the model, whose plain attention, grouped
    convolution and resizes compute in the input's type, on the f32 network
    input of the plain preprocess, resized back by the same cubic matrices.
    ``apply`` is left as it was."""
    with torch.no_grad():  # buffers that require grad stay leaves when moved
        model = copy.deepcopy(apply.model).to("cpu", torch.float64)
    tensors = trainable_tensors(model)
    for t in tensors.values():
        t.grad = None
    cfg = apply.preprocess_cfg
    src_hw = (int(images.shape[1]), int(images.shape[2]))
    net_hw = apply.net_hw or compute_resize_shape(*src_hw, cfg)
    x = fused_preprocess(images.cpu().contiguous(), net_hw, cfg.mean, cfg.std, bgr_to_rgb=apply.bgr).double()
    loss = loss_fn(lambda t: resize_planes(model(t), src_hw), x, gt.cpu().double(), alpha)
    loss.backward()
    return float(loss.detach()), {k: t.grad for k, t in tensors.items()}
