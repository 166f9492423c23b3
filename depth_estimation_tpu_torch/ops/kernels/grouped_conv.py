"""K4: grouped 3×3 convolution, stride 1, zero padding 1, NCHW.

Replaces ``depth_estimation_tpu/ops/pallas/grouped_conv.py::_kernel`` (:105,
launched by ``grouped_conv3x3_pallas``): the stride-1 conv2 of every
ResNeXt-101 32x8d bottleneck of MiDaS v2.1. The kernel is
``csrc/grouped_conv.cu``; its source note gives the bound and the design.

``grouped_conv3x3_plain`` is the plain PyTorch version: im2col
(``F.unfold``) and one matmul with the group as a batch dimension, the form
of the JAX package's ``_batched_matmul_grouped_conv``, in f32 with the
output cast to the input type (a float64 input, a gradient reference, is
computed in float64). ``grouped_conv3x3`` calls the operator
``depth_tpu_torch::grouped_conv3x3``, whose CPU implementation is the plain
version, whose CUDA implementation launches the kernel, and whose fake
implementation gives the output's shape and dtype, so that ``torch.export``
and ``torch.compile`` trace through it.

Layouts: x (B, C, H, W); weight (C, C/G, 3, 3), as ``nn.Conv2d(groups=G)``
stores it: output channel o reads the input channels of its group
``o // (C/G)``.

Gradient. The TPU kernel has none: the JAX package trains through XLA's
grouped convolution. The operator's registered backward, on both devices:
dX is itself a grouped 3×3 stride-1 convolution of dY, with each group's
weight transposed (in ↔ out) and flipped in both taps
(``transposed_weight``); C/G is the same in and out, so dX is one more call
of the operator (on the card, one more K4 launch). dW is
``weight_grad_plain``, the plain version's im2col product transposed
(dY·patchesᵀ a group, a ``torch.matmul`` with TF32 off), as XLA computes it
outside the TPU kernel.
On the H100, cuDNN's grouped ``conv2d_weight`` put one MiDaS layer-4
element 5e-4 (relative) off this product, and took 0.80 ms there (PERF.md
§6).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from depth_estimation_tpu_torch.device import at_least_f32, full_f32
from depth_estimation_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got shape {tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if tuple(weight.shape) != (c, c // groups, 3, 3):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({c}, {c // groups}, 3, 3)")


def _patches(x: torch.Tensor, groups: int) -> torch.Tensor:
    """im2col of x: (B, G, C/G·9, H·W), rows ordered (ci, kh, kw)."""
    b, c, h, w = x.shape
    return F.unfold(at_least_f32(x), 3, padding=1).reshape(b, groups, c // groups * 9, h * w)


def grouped_conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, C, H, W) → (B, C, H, W) in x's dtype, computed in f32 (float64
    for a float64 x)."""
    _check_shapes(x, weight, groups)
    c = x.shape[1]
    wk = at_least_f32(weight).reshape(groups, c // groups, c // groups * 9)  # (G, out, (ci, kh, kw))
    return torch.matmul(wk, _patches(x, groups)).reshape(x.shape).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("grouped_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_conv3x3.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.grouped_conv3x3.restype = ctypes.c_int
    lib.grouped_conv3x3_tiling.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.grouped_conv3x3_tiling.restype = ctypes.c_int
    return lib


def weight_grad_plain(x: torch.Tensor, dy: torch.Tensor, groups: int) -> torch.Tensor:
    """dW of ``grouped_conv3x3_plain`` for the output gradient ``dy``, in
    f32 (float64 for float64 inputs), cast to x's dtype: (C, C/G, 3, 3)."""
    b, c, h, w = x.shape
    cg = c // groups
    dw = torch.matmul(at_least_f32(dy).reshape(b, groups, cg, h * w), _patches(x, groups).transpose(-1, -2)).sum(0)
    return dw.reshape(c, cg, 3, 3).to(x.dtype)


def transposed_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The weight whose grouped 3×3 convolution of dY is dX: within each
    group, in and out channels swapped and both taps flipped; a new
    contiguous (C, C/G, 3, 3) tensor."""
    c, cg = weight.shape[:2]
    w = weight.reshape(groups, c // groups, cg, 3, 3).transpose(1, 2).flip(-2, -1)
    return w.reshape(c, cg, 3, 3).contiguous()


def grouped_conv3x3(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """``grouped_conv3x3_plain`` for a CPU tensor; one K4 launch for a CUDA
    tensor. The kernel takes contiguous f32 or bf16 x and weight of one
    dtype, on one device, and writes a new contiguous output, which carries
    the gradient of the operator's registered backward."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no grouped conv kernel for device {x.device}")
    return grouped_conv3x3_op(x, weight, int(groups))


@torch.library.custom_op("depth_tpu_torch::grouped_conv3x3", mutates_args=(), device_types="cuda")
def grouped_conv3x3_op(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """K4 as an operator; this body is its CUDA implementation."""
    return _launch(x, weight, groups)


@grouped_conv3x3_op.register_kernel("cpu")
def _grouped_conv3x3_cpu(x, weight, groups):
    return grouped_conv3x3_plain(x, weight, groups).contiguous()


@grouped_conv3x3_op.register_fake
def _grouped_conv3x3_fake(x, weight, groups):
    return x.new_empty(x.shape)


def _grouped_conv3x3_setup(ctx, inputs, output):
    x, weight, ctx.groups = inputs
    ctx.save_for_backward(x, weight)


def _grouped_conv3x3_backward(ctx, dy):
    """dX: the operator on ``transposed_weight`` (a K4 launch on the card);
    dW: ``weight_grad_plain``."""
    x, weight = ctx.saved_tensors
    dy = dy.contiguous()
    dx = dw = None
    with full_f32():
        if ctx.needs_input_grad[0]:
            dx = grouped_conv3x3_op(dy, transposed_weight(weight, ctx.groups), ctx.groups)
        if ctx.needs_input_grad[1]:
            dw = weight_grad_plain(x, dy, ctx.groups)
    return dx, dw, None


grouped_conv3x3_op.register_autograd(_grouped_conv3x3_backward, setup_context=_grouped_conv3x3_setup)


def _launch(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """One K4 launch on CUDA tensors, counted: the operator's CUDA implementation."""
    _check_shapes(x, weight, groups)
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"x and weight must both be float32 or bfloat16; got {x.dtype}, {weight.dtype}")
    if weight.device != x.device:
        raise ValueError(f"x on {x.device} but weight on {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("the grouped conv kernel takes contiguous x and weight")
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().grouped_conv3x3(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), b, c, h, w, groups,
            _DTYPES[x.dtype], build.sm_count(x.device.index), torch.cuda.current_stream().cuda_stream)
    build.check(err, "grouped conv kernel launch")
    build.count_launch(grouped_conv3x3)
    return out


grouped_conv3x3.launches = 0

_TILING_FIELDS = ("nco", "th", "tw", "wk", "mt", "rw", "plane", "pco", "smem_bytes")


def tiling(x_shape, groups: int, sms: int, dtype: torch.dtype) -> dict:
    """The tiling the kernel's ``dtype`` route picks for an input of
    ``x_shape`` on a card with ``sms`` SMs: output channels a block (nco),
    rows and columns a block (th, tw), warp slices over the input channels
    (wk), m16 pixel tiles a warp (mt), the staged input row and plane and
    weight row pitches in values of ``dtype`` (rw, plane, pco) and the shared
    memory a block. Builds the kernel's library, so it needs nvcc."""
    if dtype not in _DTYPES:
        raise TypeError(f"no grouped conv route for {dtype}")
    b, c, h, w = x_shape
    out = (ctypes.c_int * len(_TILING_FIELDS))()
    err = _lib().grouped_conv3x3_tiling(b, c, h, w, groups, _DTYPES[dtype], sms, out)
    build.check(err, "grouped conv tiling")
    return dict(zip(_TILING_FIELDS, out))
