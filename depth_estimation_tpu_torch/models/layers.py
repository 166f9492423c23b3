"""Shared building blocks (JAX ``models/layers.py``), NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """Inference batch norm: y = (x - running_mean)·rsqrt(running_var + eps)·weight + bias.

    The four tensors are buffers with the hub's names, so the state dict is
    the hub's (without ``num_batches_tracked``, which the forward never
    reads). There is no training mode: the forward is ``F.batch_norm`` in
    inference, one launch. They start at the identity (weight 1, bias 0,
    mean 0, var 1), as the JAX ``FrozenBatchNorm`` initializes."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
