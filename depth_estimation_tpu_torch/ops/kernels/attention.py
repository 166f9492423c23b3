"""K1: multi-head attention, softmax(QKᵀ/√D)·V: q (B, H, Nq, D), k and v (B, H, Nk, D).

Replaces ``depth_estimation_tpu/ops/pallas/attention.py::_flash_kernel``
(:34, launched by ``_flash_attention_padded``, dispatched by
``multi_head_attention``). The kernel is ``csrc/attention.cu``; its input
type alone picks the route:

* float32 runs as 3xTF32: every operand is split into a TF32 high part and
  a TF32 remainder, and lo·hi + hi·lo + hi·hi is accumulated in f32 with
  ``mma.sync.m16n8k8``, so it holds the plain version like f32 arithmetic
  does (one TF32 pass would not). Bound: three times the products' FLOPs at
  the 495 TFLOP/s TF32 rate. P stays in registers between the two products:
  the key index is permuted within each 8-key chunk of P and of V, which
  leaves P·V unchanged.
* bfloat16 runs as bf16 ``mma.sync.m16n8k16`` with f32 accumulation, K and V
  read from shared memory with ``ldmatrix``. The C fragments of S, packed to
  bf16, are the A fragments of P·V as they stand. The unnormalised
  probabilities are rounded to bf16 and divided by their f32 sum at the end.
  Bound: the products' FLOPs at the 989 TFLOP/s bf16 rate.

Both routes stage K/V tiles with ``cp.async`` into two buffers, so q, k and v
must have 16-byte aligned data pointers and (batch, head, row) strides that
are multiples of 16 bytes: 4 float32 or 8 bfloat16 elements. The wrapper
raises ``ValueError`` otherwise; the ViT's fused qkv views qualify. The
source note gives the fragment layouts.

The key length Nk may differ from the query length Nq (B, H and D match):
the grid is cut over the queries and each block walks every key, masking
past Nk, as the TPU kernel masks ``col < kv_len`` over its key block. The
sequence-parallel ViT runs it so, with its local queries against the keys
gathered over ``sp`` (``parallel/ops.py``).

``attention_plain`` is the plain PyTorch version with the semantics of the
JAX package's ``_attention_xla``: f32 logits, softmax, probabilities cast to
the input type, f32 product with V, output in the input type. A float64
input is computed in float64 throughout (a gradient reference, never a
kernel input).
``multi_head_attention`` calls the operator ``depth_tpu_torch::attention``
(``torch.ops.depth_tpu_torch.attention``): its CPU implementation is
``attention_plain``, its CUDA implementation launches the kernel, and its
fake implementation gives the output's shape and dtype, so that
``torch.export`` and ``torch.compile`` trace through it.

Gradient. The TPU kernel has none: the JAX package trains through
``_attention_xla``, so XLA differentiates plain products. The operator's
registered backward, on both devices, is ``attention_backward_plain``: P =
softmax(QKᵀ/√D) recomputed from the saved q, k and v in f32 (P is
16·577²·4 B ≈ 21 MB an image a block at 384², cheap to recompute), then dV =
PᵀdO, dS = P⊙(dP − rowsum(dO⊙O)) with dP = dO·Vᵀ, dQ = dS·K/√D and dK =
dSᵀ·Q/√D, as ``torch.matmul``s with TF32 off.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from depth_estimation_tpu_torch.device import at_least_f32, full_f32
from depth_estimation_tpu_torch.ops.kernels import build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", at_least_f32(q), at_least_f32(k)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", at_least_f32(probs), at_least_f32(v)).to(q.dtype)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor):
    """(dQ, dK, dV) of softmax(QKᵀ/√D)V for the output gradient ``do``, in
    f32 (float64 for float64 inputs) from P recomputed, each cast to its
    input's dtype. ``o`` is the forward's output."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (at_least_f32(t) for t in (q, k, v, o, do))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.attention_forward.argtypes = [p, p, p, p, i, i, i, i, i] + [ll] * 9 + [ctypes.c_float, i, p]
    lib.attention_forward.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q must be (B, H, Nq, D) and k, v (B, H, Nk, D) with one B, H and D; "
                         f"got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIM}, got {q.shape[-1]}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError(f"empty sequence: {q.shape[2]} queries, {k.shape[2]} keys")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous along the head dimension")
    vec = 16 // q.element_size()  # elements a 16-byte copy
    for name, t in zip("qkv", (q, k, v)):
        # a stride of a size-1 axis is never used by the kernel
        strides = [s for s, size in zip(t.stride()[:3], t.shape[:3]) if size > 1]
        if t.data_ptr() % 16 or any(s % vec for s in strides):
            raise ValueError(
                f"{name} is not aligned for the {q.dtype} kernel's 16-byte copies: data pointer at "
                f"{t.data_ptr() % 16} bytes past a 16-byte boundary, strides {t.stride()} (the "
                f"batch, head and row strides must be multiples of {vec} elements)")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√D)V for q (B, H, Nq, D) and k, v (B, H, Nk, D); output
    (B, H, Nq, D) in q's dtype.

    CPU tensors take ``attention_plain``. CUDA tensors launch the kernel,
    which reads q, k and v through their strides (the last axis must be
    contiguous, and the alignment above holds) and needs D = 64. The output
    carries the gradient of ``attention_backward_plain``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    return attention_op(q, k, v)


@torch.library.custom_op("depth_tpu_torch::attention", mutates_args=(), device_types="cuda")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1 as an operator; this body is its CUDA implementation."""
    return _launch(q, k, v)


@attention_op.register_kernel("cpu")
def _attention_cpu(q, k, v):
    return attention_plain(q, k, v).contiguous()


@attention_op.register_fake
def _attention_fake(q, k, v):
    return q.new_empty(q.shape)


def _attention_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output)


def _attention_backward(ctx, do):
    with full_f32():
        return attention_backward_plain(*ctx.saved_tensors, do)


attention_op.register_autograd(_attention_backward, setup_context=_attention_setup)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, counted: the operator's CUDA implementation."""
    _check(q, k, v)
    b, h, nq, d = q.shape
    out = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _lib().attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq, k.shape[2], d, *strides,
            1.0 / math.sqrt(d), _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "attention kernel launch")
    build.count_launch(multi_head_attention)
    return out


multi_head_attention.launches = 0
