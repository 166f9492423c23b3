"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels have no CPU mode, so every test here skips without a CUDA GPU.
This file imports no JAX, so it also runs where JAX is not installed; there,
skip the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.device import full_f32
from depth_estimation_tpu_torch.ops.kernels import attention as tatt
from depth_estimation_tpu_torch.ops.kernels import grouped_conv as tgc
from depth_estimation_tpu_torch.ops.kernels import resize as trsz

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    with full_f32():
        yield torch.device("cuda")


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


@pytest.mark.parametrize("n,dtype,tol", [(769, torch.float32, 2e-5), (577, torch.float32, 2e-5),
                                         (65, torch.float32, 2e-5), (769, torch.bfloat16, 1e-2)])
def test_attention_kernel_matches_plain(cuda, gen, n, dtype, tol):
    # strided q, k, v views of one fused projection, as the ViT gives them;
    # bf16: the kernel rounds the unnormalised probabilities to bf16, the
    # plain version the normalised ones
    qkv = torch.randn((2, n, 3, 16, 64), generator=gen, device=cuda).to(dtype).permute(2, 0, 3, 1, 4)
    before = tatt.multi_head_attention.launches
    got = tatt.multi_head_attention(qkv[0], qkv[1], qkv[2])
    torch.cuda.synchronize()
    assert tatt.multi_head_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, 16, n, 64) and got.is_contiguous()
    ref = tatt.attention_plain(qkv[0], qkv[1], qkv[2])
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=max(tol, 1e-4))


@pytest.mark.parametrize("b,n,q_scale", [(1, 1, 1.0), (1, 16, 1.0), (1, 64, 1.0), (1, 128, 1.0), (4, 769, 1.0),
                                         (2, 769, 4.0)])
def test_attention_f32_kernel_tiles_and_batch(cuda, gen, b, n, q_scale):
    """Less than one tile, exact multiples of the 64-key tile, the stream's
    microbatch of 4, and logits of std 4 whose row max moves across tiles."""
    qkv = torch.randn((b, n, 3, 16, 64), generator=gen, device=cuda).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * q_scale, qkv[1], qkv[2]
    got = tatt.multi_head_attention(q, k, v)
    torch.testing.assert_close(got, tatt.attention_plain(q, k, v), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,n,q_scale", [(1, 1, 1.0), (1, 16, 1.0), (1, 64, 1.0), (1, 65, 1.0), (1, 128, 1.0),
                                         (1, 577, 1.0), (4, 769, 1.0), (2, 769, 4.0)])
def test_attention_bf16_kernel_tiles_and_batch(cuda, gen, b, n, q_scale):
    """The bf16 route at less than one 32-key tile, two tiles and one key
    past them, exact multiples of the tile, DPT_Large at 384², the stream's
    microbatch of 4, and logits of std 4 whose row max moves across tiles."""
    qkv = torch.randn((b, n, 3, 16, 64), generator=gen, device=cuda).bfloat16().permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * q_scale, qkv[1], qkv[2]
    got = tatt.multi_head_attention(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 16, n, 64)
    torch.testing.assert_close(got.float(), tatt.attention_plain(q, k, v).float(), atol=1e-2, rtol=1e-2)


def test_attention_f32_kernel_large_logits(cuda, gen):
    """q scaled by 30: logits of std 30, so every tile rescales the running
    max and sum by factors near 0. At that size f32 itself lands some 4e-5
    from the exact result (the rounding of logits near 100), so the kernel
    and the plain version are both held against a float64 evaluation: the
    kernel within twice the plain version's distance, as f32 arithmetic."""
    qkv = torch.randn((1, 769, 3, 16, 64), generator=gen, device=cuda).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * 30, qkv[1], qkv[2]
    exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8, dim=-1) @ v.double()
    got = tatt.multi_head_attention(q, k, v)
    plain_err = (tatt.attention_plain(q, k, v).double() - exact).abs().max().item()
    assert (got.double() - exact).abs().max().item() <= max(2 * plain_err, 2e-5)


def test_attention_f32_kernel_refuses_unaligned(cuda, gen):
    base = torch.randn((1, 2, 16, 66), generator=gen, device=cuda)
    flat = torch.randn(1 + 2 * 16 * 64, generator=gen, device=cuda)
    before = tatt.multi_head_attention.launches
    row_stride_66 = base[..., :64]
    offset_pointer = flat[1:].view(1, 2, 16, 64)
    # bf16 copies 8 elements at a time: a row stride of 68 (a multiple of 4) is refused too
    row_stride_68 = torch.randn((1, 2, 16, 68), generator=gen, device=cuda).bfloat16()[..., :64]
    bf16 = (base.bfloat16()[..., :64], flat.bfloat16()[1:].view(1, 2, 16, 64), row_stride_68)
    for bad in (row_stride_66, offset_pointer, *bf16):
        with pytest.raises(ValueError, match="aligned"):
            tatt.multi_head_attention(bad, bad, bad)
    assert tatt.multi_head_attention.launches == before


def test_attention_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 2, 16, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim 64"):
        tatt.multi_head_attention(q, q, q)


@pytest.mark.parametrize("batch", [1, 4])
def test_preprocess_kernel_matches_plain(cuda, batch):
    cfg = DPT_PREPROCESS
    rng = np.random.default_rng(batch)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, 480, 640, 3), np.uint8)).to(cuda)
    before = trsz.fused_preprocess.launches
    got = trsz.fused_preprocess(imgs, (384, 512), cfg.mean, cfg.std)
    assert trsz.fused_preprocess.launches == before + 1
    ref = trsz.preprocess_plain(imgs, (384, 512), cfg.mean, cfg.std)
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("method,align_corners,in_hw,out_hw", [
    ("cubic", False, (384, 512), (480, 640)), ("cubic", False, (480, 640), (384, 512)),
    ("linear", True, (24, 32), (48, 64)), ("linear", False, (3, 5), (7, 2))])
def test_resize_kernel_matches_plain(cuda, gen, method, align_corners, in_hw, out_hw):
    x = torch.rand((2, *in_hw), generator=gen, device=cuda)
    before = trsz.resize_planes.launches
    got = trsz.resize_planes(x, out_hw, method, align_corners)
    assert trsz.resize_planes.launches == before + 1
    ref = trsz.resize_planes_plain(x, out_hw, method, align_corners)
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=0)


# MiDaS v2.1's stride-1 conv2s at a 480×640 source (192×256 network input), G = 32
MIDAS_CONV2_SHAPES = [(256, 48, 64), (512, 24, 32), (1024, 12, 16), (2048, 6, 8)]


def _grouped_inputs(gen, b, c, h, w, g, dtype, device):
    x = torch.randn((b, c, h, w), generator=gen, device=device).to(dtype)
    k = (torch.randn((c, c // g, 3, 3), generator=gen, device=device) / (9 * c // g) ** 0.5).to(dtype)
    return x, k


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("c,h,w", MIDAS_CONV2_SHAPES, ids=["layer1", "layer2", "layer3", "layer4"])
def test_grouped_conv_kernel_matches_plain(cuda, gen, c, h, w, batch, dtype, tol):
    x, k = _grouped_inputs(gen, batch, c, h, w, 32, dtype, cuda)
    before = tgc.grouped_conv3x3.launches
    got = tgc.grouped_conv3x3(x, k, 32)
    torch.cuda.synchronize()
    assert tgc.grouped_conv3x3.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    # the same f32 products in another order; bf16 rounds both once at the end
    torch.testing.assert_close(got.float(), tgc.grouped_conv3x3_plain(x, k, 32).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)], ids=["f32", "bf16"])
def test_grouped_conv_kernel_odd_small_shape(cuda, gen, dtype, tol):
    """C/G = 2 and odd H, W: the tiles' ragged edges and a channel tile wider than the group."""
    x, k = _grouped_inputs(gen, 2, 8, 5, 7, 4, dtype, cuda)
    got = tgc.grouped_conv3x3(x, k, 4)
    torch.testing.assert_close(got.float(), tgc.grouped_conv3x3_plain(x, k, 4).float(), atol=tol, rtol=tol)


def test_grouped_conv_kernel_counts_each_launch(cuda, gen):
    x, k = _grouped_inputs(gen, 1, 64, 9, 11, 8, torch.float32, cuda)
    before = tgc.grouped_conv3x3.launches
    for i in range(3):
        tgc.grouped_conv3x3(x, k, 8)
        assert tgc.grouped_conv3x3.launches == before + i + 1


def test_grouped_conv_kernel_refuses(cuda, gen):
    x, k = _grouped_inputs(gen, 1, 64, 8, 8, 8, torch.float32, cuda)
    before = tgc.grouped_conv3x3.launches
    with pytest.raises(ValueError, match="weight shape"):
        tgc.grouped_conv3x3(x, k[:, :4].contiguous(), 8)
    with pytest.raises(ValueError, match="not divisible"):
        tgc.grouped_conv3x3(x, k, 7)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tgc.grouped_conv3x3(x.half(), k.half(), 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tgc.grouped_conv3x3(x, k.bfloat16(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tgc.grouped_conv3x3(x.transpose(2, 3), k, 8)
    with pytest.raises(ValueError, match="weight on"):
        tgc.grouped_conv3x3(x, k.cpu(), 8)
    assert tgc.grouped_conv3x3.launches == before
