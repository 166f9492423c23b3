"""K1: multi-head attention, softmax(QKᵀ/√D)·V over (B, H, N, D) tensors.

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

``attention_plain`` is the plain PyTorch version with the semantics of the
JAX package's ``_attention_xla``: f32 logits, softmax, probabilities cast to
the input type, f32 product with V, output in the input type.
``multi_head_attention`` takes it for CPU tensors and launches the kernel
for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from depth_estimation_tpu_torch.ops.kernels import build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.attention_forward.argtypes = [p, p, p, p, i, i, i, i] + [ll] * 9 + [ctypes.c_float, i, p]
    lib.attention_forward.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape; got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIM}, got {q.shape[-1]}")
    if q.shape[2] < 1:
        raise ValueError("empty sequence")
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
    """softmax(QKᵀ/√D)V over (B, H, N, D) tensors; output (B, H, N, D) in q's dtype.

    CPU tensors take ``attention_plain``. CUDA tensors launch the kernel,
    which reads q, k and v through their strides (the last axis must be
    contiguous, and the alignment above holds) and needs D = 64."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _lib().attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, d, *strides,
            1.0 / math.sqrt(d), _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "attention kernel launch")
    multi_head_attention.launches += 1
    return out


multi_head_attention.launches = 0
