"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels have no CPU mode, so every test here skips without a CUDA GPU.
This file imports no JAX, so it also runs where JAX is not installed; there,
skip the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.config import CARD, DPT_PREPROCESS, SMALL_PREPROCESS
from depth_estimation_tpu_torch.device import full_f32
from depth_estimation_tpu_torch.ops.kernels import attention as tatt
from depth_estimation_tpu_torch.ops.kernels import dense as tlin
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 4])
def test_attention_kernel_at_vit_b_heads(cuda, gen, b, dtype, tol):
    """DPT_Hybrid's ViT-B: 12 heads of 64 over a fused qkv of 3 × 768, at
    384×512 (769 tokens), per frame and at the stream's microbatch of 4."""
    qkv = torch.randn((b, 769, 3, 12, 64), generator=gen, device=cuda).to(dtype).permute(2, 0, 3, 1, 4)
    before = tatt.multi_head_attention.launches
    got = tatt.multi_head_attention(qkv[0], qkv[1], qkv[2])
    assert tatt.multi_head_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, 12, 769, 64)
    ref = tatt.attention_plain(qkv[0], qkv[1], qkv[2])
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=max(tol, 1e-4))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("heads,tp", [(16, 2), (16, 4), (12, 2), (12, 4)],
                         ids=["dpt_large_tp2", "dpt_large_tp4", "dpt_hybrid_tp2", "dpt_hybrid_tp4"])
def test_attention_kernel_at_tensor_parallel_heads(cuda, gen, heads, tp, dtype, tol):
    """One tensor-parallel rank's heads (``parallel/mesh.py``): H/tp heads of
    64 as views of its fused qkv of 3·C/tp columns, at 577 tokens."""
    h = heads // tp
    qkv = torch.randn((1, 577, 3, h, 64), generator=gen, device=cuda).to(dtype).permute(2, 0, 3, 1, 4)
    before = tatt.multi_head_attention.launches
    got = tatt.multi_head_attention(qkv[0], qkv[1], qkv[2])
    assert tatt.multi_head_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, h, 577, 64)
    ref = tatt.attention_plain(qkv[0], qkv[1], qkv[2])
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=max(tol, 1e-4))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,nq,nk", [(1, 2, 17, 65), (2, 3, 129, 300), (1, 4, 100, 70), (1, 4, 17, 300),
                                       (1, 2, 129, 33), (1, 16, 385, 769), (1, 16, 193, 769)],
                         ids=["17x65", "129x300", "nk70", "nq17", "nk_lt_nq", "sp2", "sp4"])
def test_attention_kernel_with_its_own_key_length(cuda, gen, b, h, nq, nk, dtype, tol):
    """Nq queries against Nk keys, as a sequence-parallel rank runs K1: q a
    view of the rank's fused projection, k and v views of the gathered K/V.
    Key lengths off both routes' tiles (64 f32, 32 bf16), fewer than one
    f32 query tile (17), fewer keys than queries, and DPT_Large's 769 tokens
    over sp 2 and 4 (385 and 193 queries on rank 0)."""
    q = torch.randn((b, nq, 3, h, 64), generator=gen, device=cuda).to(dtype).permute(2, 0, 3, 1, 4)[0]
    kv = torch.randn((b, nk, 2, h, 64), generator=gen, device=cuda).to(dtype).permute(2, 0, 3, 1, 4)
    before = tatt.multi_head_attention.launches
    got = tatt.multi_head_attention(q, kv[0], kv[1])
    torch.cuda.synchronize()
    assert tatt.multi_head_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, nq, 64) and got.is_contiguous()
    ref = tatt.attention_plain(q, kv[0], kv[1])
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=max(tol, 1e-4))


def test_attention_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 2, 16, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim 64"):
        tatt.multi_head_attention(q, q, q)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("cfg,out_hw", [(DPT_PREPROCESS, (384, 512)), (SMALL_PREPROCESS, (192, 256))],
                         ids=["dpt", "midas"])
def test_preprocess_kernel_matches_plain(cuda, batch, cfg, out_hw):
    rng = np.random.default_rng(batch)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, 480, 640, 3), np.uint8)).to(cuda)
    before = trsz.fused_preprocess.launches
    got = trsz.fused_preprocess(imgs, out_hw, cfg.mean, cfg.std)
    assert trsz.fused_preprocess.launches == before + 1
    ref = trsz.preprocess_plain(imgs, out_hw, cfg.mean, cfg.std)
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=0)


# K2's linear route at the fused iris path's detector inputs: (out_hw, mean,
# std) → (th, tw, blocks) at batch 1 and 4 on 132 SMs
_K2_DETECTORS = {((128, 128), (0.5,) * 3, (0.5,) * 3): ((2, 32, 256), (8, 32, 256)),
                 ((256, 256), (0.0,) * 3, (1.0,) * 3): ((4, 64, 256), (16, 64, 256))}


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("out_hw,mean,std", list(_K2_DETECTORS), ids=["blazeface", "blazepose"])
def test_preprocess_kernel_linear_route_at_detector_shapes(cuda, batch, out_hw, mean, std):
    """480×640 u8 → the detectors' inputs by K2's linear route, against the
    plain version at 1e-5, one launch, at the tilings the CPU tests walk."""
    th, tw, blocks = _K2_DETECTORS[(out_hw, mean, std)][batch == 4]
    t = trsz.tiling((480, 640), out_hw, batch, 132, "preprocess", "linear")
    assert (t["th"], t["tw"], t["blocks"]) == (th, tw, blocks), t
    rng = np.random.default_rng(batch)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, 480, 640, 3), np.uint8)).to(cuda)
    before = trsz.fused_preprocess.launches
    got = trsz.fused_preprocess(imgs, out_hw, mean, std, method="linear")
    assert trsz.fused_preprocess.launches == before + 1
    ref = trsz.preprocess_plain(imgs, out_hw, mean, std, method="linear")
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def _offset_view(x, offset):
    """A contiguous copy of x whose data pointer lies ``offset`` values past
    an allocation's 16-byte-aligned start."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:].copy_(x.reshape(-1))
    return flat[offset:].view(x.shape)


@pytest.mark.parametrize("shape,out_hw,offset", [
    ((1, 7, 11, 3), (5, 9), 0), ((2, 3, 5, 3), (7, 2), 0), ((1, 50, 37, 3), (96, 130), 0),
    ((1, 480, 640, 3), (384, 512), 1), ((2, 480, 640, 3), (192, 256), 5)],
    ids=["7x11", "3x5", "odd_w", "offset1", "offset5_midas"])
def test_preprocess_kernel_ragged_and_unaligned(cuda, shape, out_hw, offset):
    """Rows of 33, 15 and 111 bytes (not multiples of 16), a 3×5 frame, and
    aligned shapes at a pointer 1 or 5 bytes past a 16-byte boundary: all
    staged by ordinary loads, in the same kernel."""
    cfg = DPT_PREPROCESS
    rng = np.random.default_rng(7)
    imgs = _offset_view(torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(cuda), offset)
    before = trsz.fused_preprocess.launches
    got = trsz.fused_preprocess(imgs, out_hw, cfg.mean, cfg.std)
    assert trsz.fused_preprocess.launches == before + 1
    torch.testing.assert_close(got, trsz.preprocess_plain(imgs, out_hw, cfg.mean, cfg.std), atol=3e-5, rtol=0)


@pytest.mark.parametrize("method,align_corners,in_hw,out_hw", [
    ("cubic", False, (384, 512), (480, 640)), ("cubic", False, (192, 256), (480, 640)),
    ("cubic", False, (480, 640), (384, 512)), ("linear", True, (24, 32), (48, 64)), ("linear", False, (3, 5), (7, 2)),
    ("cubic", False, (41, 67), (300, 131)), ("linear", True, (5, 3), (2, 7))])
def test_resize_kernel_matches_plain(cuda, gen, method, align_corners, in_hw, out_hw):
    x = torch.rand((2, *in_hw), generator=gen, device=cuda)
    before = trsz.resize_planes.launches
    got = trsz.resize_planes(x, out_hw, method, align_corners)
    assert trsz.resize_planes.launches == before + 1
    ref = trsz.resize_planes_plain(x, out_hw, method, align_corners)
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("in_hw", [(384, 512), (192, 256)], ids=["dpt", "midas"])
def test_resize_kernel_batches_and_unaligned(cuda, gen, batch, in_hw):
    """The main paths' K3 at the stream's microbatch, and at a pointer one
    value past a 16-byte boundary (ordinary loads)."""
    x = torch.rand((batch, *in_hw), generator=gen, device=cuda)
    for planes in (x, _offset_view(x, 1)):
        before = trsz.resize_planes.launches
        got = trsz.resize_planes(planes, (480, 640))
        assert trsz.resize_planes.launches == before + 1
        torch.testing.assert_close(got, trsz.resize_planes_plain(planes, (480, 640)), atol=3e-5, rtol=0)


def _assert_u8_agrees(got, want, f32):
    """Bytes may differ only where the f32 map lies within 1e-3 of an integer,
    where two orders of summation can truncate differently (the rule of
    tests/test_torch_estimator.py)."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.uint8
    differ = got != want
    near_int = (f32 - f32.round()).abs() < 1e-3
    assert not (differ & ~near_int).any(), f"{int((differ & ~near_int).sum())} bytes differ away from an integer"


@pytest.mark.parametrize("shape,out_hw,offset", [
    ((1, 384, 512), (480, 640), 0), ((4, 384, 512), (480, 640), 0), ((1, 192, 256), (480, 640), 0),
    ((4, 192, 256), (480, 640), 0), ((2, 41, 67), (300, 131), 0), ((1, 384, 512), (480, 640), 1)],
    ids=["dpt", "dpt_b4", "midas", "midas_b4", "ragged", "offset1"])
def test_resize_kernel_u8_route(cuda, gen, shape, out_hw, offset):
    """K3's fused wrap-around cast against ``wraparound_u8`` of the plain
    resize, on depth-like values from -50 to 550 (negatives and values past
    255 wrap)."""
    x = _offset_view(torch.rand(shape, generator=gen, device=cuda) * 600 - 50, offset)
    before = trsz.resize_planes.launches
    got = trsz.resize_planes(x, out_hw, output="u8")
    assert trsz.resize_planes.launches == before + 1
    f32 = trsz.resize_planes_plain(x, out_hw)
    _assert_u8_agrees(got, trsz.resize_planes_plain(x, out_hw, output="u8"), f32)


# (kernel, in_hw, out_hw) → (th, tw, blocks) at batch 1 and 4 on 132 SMs, the
# tilings whose windows tests/test_torch_kernels.py walks
_K23_TILINGS = {("preprocess", (480, 640), (384, 512)): ((6, 128, 256), (24, 128, 256)),
                ("preprocess", (480, 640), (192, 256)): ((3, 64, 256), (12, 64, 256)),
                ("resize", (384, 512), (480, 640)): ((10, 128, 240), (32, 128, 300)),
                ("resize", (192, 256), (480, 640)): ((10, 128, 240), (32, 128, 300))}


def _windows(in_h, out_h, n):
    """Each of n ranks' output rows [r0, r1) and the source rows [lo, hi) they read."""
    from depth_estimation_tpu_torch.parallel.spatial import row_bounds

    return [(r0, r1, *trsz.window_rows(in_h, out_h, r0, r1)) for r0, r1 in row_bounds(out_h, n)]


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("cfg,out_hw", [(DPT_PREPROCESS, (384, 512)), (SMALL_PREPROCESS, (192, 256))],
                         ids=["dpt", "midas"])
def test_preprocess_kernel_row_windows(cuda, cfg, out_hw, n):
    """K2 on each of n ranks' output-row windows of a 480×640 frame
    (``parallel/spatial.py``), from the source rows they read: one launch
    each, against the plain version on the same window and against the
    whole-frame launch's rows."""
    rng = np.random.default_rng(n)
    imgs = torch.from_numpy(rng.integers(0, 256, (1, 480, 640, 3), np.uint8)).to(cuda)
    whole = trsz.fused_preprocess(imgs, out_hw, cfg.mean, cfg.std)
    for r0, r1, lo, hi in _windows(480, out_hw[0], n):
        slab, window = imgs[:, lo:hi].contiguous(), (r0, r1, 480, lo)
        before = trsz.fused_preprocess.launches
        got = trsz.fused_preprocess(slab, out_hw, cfg.mean, cfg.std, window=window)
        assert trsz.fused_preprocess.launches == before + 1 and got.shape == (1, 3, r1 - r0, out_hw[1])
        torch.testing.assert_close(got, trsz.preprocess_plain(slab, out_hw, cfg.mean, cfg.std, window=window),
                                   atol=3e-5, rtol=0)
        torch.testing.assert_close(got, whole[:, :, r0:r1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("in_hw", [(384, 512), (192, 256)], ids=["dpt", "midas"])
def test_resize_kernel_row_windows(cuda, gen, in_hw, n):
    """K3 on each of n ranks' output-row windows of the 480×640 map, as K2's above."""
    x = torch.rand((1, *in_hw), generator=gen, device=cuda)
    whole = trsz.resize_planes(x, (480, 640))
    for r0, r1, lo, hi in _windows(in_hw[0], 480, n):
        slab, window = x[:, lo:hi].contiguous(), (r0, r1, in_hw[0], lo)
        before = trsz.resize_planes.launches
        got = trsz.resize_planes(slab, (480, 640), window=window)
        assert trsz.resize_planes.launches == before + 1 and got.shape == (1, r1 - r0, 640)
        torch.testing.assert_close(got, trsz.resize_planes_plain(slab, (480, 640), window=window), atol=3e-5, rtol=0)
        torch.testing.assert_close(got, whole[:, r0:r1], atol=1e-6, rtol=0)


def test_resize_tilings_at_main_shapes(cuda):
    for (kernel, in_hw, out_hw), want in _K23_TILINGS.items():
        for batch, (th, tw, blocks) in zip((1, 4), want):
            t = trsz.tiling(in_hw, out_hw, batch, 132, kernel)
            assert (t["th"], t["tw"], t["blocks"]) == (th, tw, blocks), (kernel, in_hw, out_hw, batch, t)
            assert t["blocks"] <= 132 * t["blocks_per_sm"]


def test_resize_kernels_refuse(cuda, gen):
    x = torch.rand((1, 8, 8), generator=gen, device=cuda)
    before = (trsz.resize_planes.launches, trsz.fused_preprocess.launches)
    with pytest.raises(ValueError, match="output must be"):
        trsz.resize_planes(x, (4, 4), output="u16")
    with pytest.raises(ValueError, match="cubic or linear"):
        trsz.resize_planes(x, (4, 4), "nearest")
    with pytest.raises(ValueError, match="contiguous"):
        trsz.resize_planes(x.transpose(1, 2), (4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        trsz.fused_preprocess(torch.zeros((1, 8, 8, 3), device=cuda), (4, 4), (0.5,) * 3, (0.5,) * 3)
    with pytest.raises(ValueError, match="3-channel"):
        trsz.fused_preprocess(torch.zeros((1, 8, 8, 4), dtype=torch.uint8, device=cuda), (4, 4), (0.5,) * 3,
                              (0.5,) * 3)
    assert (trsz.resize_planes.launches, trsz.fused_preprocess.launches) == before


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


_RAGGED = [(1, 96, 12, 16, 8), (2, 96, 5, 7, 8), (1, 64, 9, 11, 8), (1, 40, 3, 5, 2)]
_RAGGED_IDS = ["cg12", "cg12_5x7", "hw99", "cg20_3x5"]


@pytest.mark.parametrize("b,c,h,w,g", _RAGGED, ids=_RAGGED_IDS)
def test_grouped_conv_f32_kernel_ragged(cuda, gen, b, c, h, w, g):
    """The f32 route with C/G not a multiple of 8 (12, 20: k and n padded
    with zeros in shared memory) and H·W not a multiple of 16 (35, 99, 15:
    pixel rows past the map masked at the store)."""
    x, k = _grouped_inputs(gen, b, c, h, w, g, torch.float32, cuda)
    got = tgc.grouped_conv3x3(x, k, g)
    torch.testing.assert_close(got, tgc.grouped_conv3x3_plain(x, k, g), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,c,h,w,g,offset",
                         [(*shape, 0) for shape in _RAGGED] + [(1, 256, 8, 16, 32, 1), (1, 256, 6, 128, 32, 0)],
                         ids=_RAGGED_IDS + ["offset_pointer", "w128"])
def test_grouped_conv_bf16_kernel_ragged(cuda, gen, b, c, h, w, g, offset):
    """The bf16 route where the 16-byte staging does not apply, so every
    value is an ordinary load: C/G 12 and 20 (weight rows not multiples of
    8 values), W = 7, 11, 5 (rows not 16-byte aligned), and an x pointer one
    value past a 16-byte boundary at an otherwise aligned shape; H·W 35, 99
    and 15 leave pixel rows past the map. And W = 128, aligned, in two
    column tiles, so the halo pairs between them lie in the image."""
    x, k = _grouped_inputs(gen, b, c, h, w, g, torch.bfloat16, cuda)
    if offset:
        flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=cuda)
        flat[offset:].copy_(x.reshape(-1))
        x = flat[offset:].view(x.shape)
    got = tgc.grouped_conv3x3(x, k, g)
    torch.testing.assert_close(got.float(), tgc.grouped_conv3x3_plain(x, k, g).float(), atol=1e-2, rtol=1e-2)


def test_grouped_conv_f32_kernel_large_inputs(cuda, gen):
    """Layer 4 with inputs ×30 (outputs up to about 100): held against a
    float64 convolution on the CPU within 1e-5 of the outputs' range, the
    1e-4 of the unscaled case relative to its range; the plain f32 version's
    distance is printed beside it."""
    x, k = _grouped_inputs(gen, 1, 2048, 6, 8, 32, torch.float32, cuda)
    x = x * 30
    exact = torch.nn.functional.conv2d(x.cpu().double(), k.cpu().double(), padding=1, groups=32)
    got_err = (tgc.grouped_conv3x3(x, k, 32).cpu().double() - exact).abs().max().item()
    plain_err = (tgc.grouped_conv3x3_plain(x, k, 32).cpu().double() - exact).abs().max().item()
    print(f"x30 layer 4: kernel {got_err:.3g}, plain {plain_err:.3g}, max |y| {exact.abs().max().item():.4g}")
    assert got_err <= 1e-5 * exact.abs().max().item()


def test_grouped_conv_bf16_kernel_large_inputs(cuda, gen):
    """Layer 4 in bf16 with inputs ×30 (outputs up to about 100), against a
    float64 convolution of the same bf16 values on the CPU: within one
    rounding to bf16 of the exact result (2^-8 of it) plus 1e-4 of the
    outputs' range for the f32 sums; the plain version's distance is printed
    beside it."""
    x, k = _grouped_inputs(gen, 1, 2048, 6, 8, 32, torch.bfloat16, cuda)
    x = x * 30
    exact = torch.nn.functional.conv2d(x.cpu().double(), k.cpu().double(), padding=1, groups=32)
    got = tgc.grouped_conv3x3(x, k, 32).cpu().double()
    got_err = (got - exact).abs().max().item()
    plain_err = (tgc.grouped_conv3x3_plain(x, k, 32).cpu().double() - exact).abs().max().item()
    scale = exact.abs().max().item()
    print(f"bf16 x30 layer 4: kernel {got_err:.3g}, plain {plain_err:.3g}, max |y| {scale:.4g}")
    torch.testing.assert_close(got, exact, rtol=2.0 ** -8, atol=1e-4 * scale)


# the tilings that tests/test_torch_kernels.py's lane-mapping and bank tests
# assume, at batch 1 on 132 SMs: (C, H, W) → (nco, th, tw, wk, mt)
_MIDAS_TILINGS = {(256, 48, 64): (8, 4, 64, 1, 4), (512, 24, 32): (16, 4, 32, 1, 2),
                  (1024, 12, 16): (16, 3, 16, 4, 3), (2048, 6, 8): (8, 6, 8, 4, 3)}


def test_grouped_conv_f32_tilings_at_midas_shapes(cuda):
    """The tilings that tests/test_torch_kernels.py's lane-mapping and bank
    tests assume are the ones the kernel picks, at batch 1 on 132 SMs."""
    for (c, h, w), tiling in _MIDAS_TILINGS.items():
        got = tgc.tiling((1, c, h, w), 32, 132, torch.float32)
        assert tuple(got[f] for f in ("nco", "th", "tw", "wk", "mt")) == tiling, (c, got)
        assert got["rw"] == got["tw"] + 8 and got["plane"] % 16 == 8 and got["pco"] % 8 == 4


def test_grouped_conv_bf16_tilings_at_midas_shapes(cuda):
    """The bf16 route takes the f32 route's tiling with its own pitches, in
    bf16 values: rows of tw + 16 (the tile from element 8, a halo pair on
    either side, 16-byte multiples), planes ≡ 8 (mod 32) and weight rows
    ≡ 8 (mod 16), as tests/test_torch_kernels.py's bf16 lane-mapping and bank
    tests assume; and less shared memory than the f32 route."""
    for (c, h, w), tiling in _MIDAS_TILINGS.items():
        got = tgc.tiling((1, c, h, w), 32, 132, torch.bfloat16)
        f32 = tgc.tiling((1, c, h, w), 32, 132, torch.float32)
        assert tuple(got[f] for f in ("nco", "th", "tw", "wk", "mt")) == tiling, (c, got)
        assert got["rw"] == got["tw"] + 16 and got["plane"] % 32 == 8 and got["pco"] % 16 == 8, (c, got)
        assert got["plane"] >= (got["th"] + 2) * got["rw"] and got["pco"] >= 72 * got["wk"]
        assert got["smem_bytes"] < f32["smem_bytes"]


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


@pytest.mark.parametrize("name", ["MiDaS_small", "DPT_Hybrid"])
def test_estimator_on_the_card_holds_the_cpu(cuda, name):
    """A full-width family on the card (its kernels) against the same weights
    on the CPU (the plain versions) at 240×320, within the package's accuracy
    gate; K4 is not on either family's path."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops import kernels

    est = DepthEstimator(name, seed=0, verbose=False)
    assert est.device.type == "cuda"
    cpu = DepthEstimator(name, params={k: v.cpu() for k, v in est.model.state_dict().items()}, verbose=False,
                         device="cpu")
    frame = np.random.default_rng(0).integers(0, 256, (240, 320, 3), np.uint8)
    kernels.reset_launch_counts()
    got = est.predict(frame)
    counts = kernels.launch_counts()
    assert counts == {"multi_head_attention": 12 if name == "DPT_Hybrid" else 0, "fused_preprocess": 1,
                      "resize_planes": 1, "grouped_conv3x3": 0, "linear": 50 if name == "DPT_Hybrid" else 0}, counts
    want = cpu.predict(frame)
    scale = float(np.abs(want).max())
    assert np.isfinite(got).all() and scale > 0
    assert float(np.abs(got - want).max()) / scale < 1e-3


def test_fused_program_on_the_card_holds_the_cpu(cuda, tmp_path, monkeypatch):
    """The fused iris/pose + DPT_Large program on the card (its kernels)
    against the same weights on the CPU at 240×320, on a hit: depth within
    the accuracy gate, detections within 1e-4; launches K1 24, K2 3, K3 1."""
    import warnings

    from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.geometry.face import FaceDet
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.fused import FusedFrameRunner

    monkeypatch.setenv("DEPTH_ESTIMATION_TPU_TORCH_CACHE", str(tmp_path))  # random weights, whatever ~/.cache holds
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = DepthEstimator("DPT_Large", seed=0, verbose=False)
        det = PersonDetector(FaceDet(20, CARD), minDetectionCon=0.0, seed=0)
    cpu_est = DepthEstimator("DPT_Large", params={k: v.cpu() for k, v in est.model.state_dict().items()},
                             verbose=False, device="cpu")
    params = {key: net.state_dict() for key, net in (("blazeface", det._face_det), ("facemesh", det._mesh),
                                                      ("blazepose", det._pose))}
    cpu_det = PersonDetector(FaceDet(20, CARD), minDetectionCon=0.0, params={k: {n: v.cpu() for n, v in sd.items()}
                                                                           for k, sd in params.items()}, device="cpu")
    frame = np.random.default_rng(0).integers(0, 256, (240, 320, 3), np.uint8)
    kernels.reset_launch_counts()
    got = {k: v.cpu().numpy() for k, v in FusedFrameRunner(est, det)(frame).items()}
    assert kernels.launch_counts() == {"multi_head_attention": 24, "fused_preprocess": 3, "resize_planes": 1,
                                       "grouped_conv3x3": 0, "linear": 100}
    want = {k: v.numpy() for k, v in FusedFrameRunner(cpu_est, cpu_det)(frame).items()}
    scale = float(np.abs(want["depth"]).max())
    assert np.isfinite(got["depth"]).all() and float(np.abs(got["depth"] - want["depth"]).max()) / scale < 1e-3
    assert got["valid"][0] and want["valid"][0]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4, rtol=0)


# -- gradients: the kernels' autograd Functions against autograd of the plain versions --

def _grads(fn, inputs, upstream):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, upstream)


@pytest.mark.parametrize("b,n", [(2, 577), (1, 65)])
def test_attention_gradients_match_plain(cuda, gen, b, n):
    """The kernel's output carries attention_backward_plain's dQ, dK, dV into
    the fused qkv projection the views come from."""
    qkv = torch.randn((b, n, 3, 16, 64), generator=gen, device=cuda)
    do = torch.randn((b, 16, n, 64), generator=gen, device=cuda)
    before = tatt.multi_head_attention.launches
    (got,) = _grads(lambda t: tatt.multi_head_attention(*t.permute(2, 0, 3, 1, 4)), [qkv], do)
    assert tatt.multi_head_attention.launches == before + 1  # the backward launches nothing
    (want,) = _grads(lambda t: tatt.attention_plain(*t.permute(2, 0, 3, 1, 4)), [qkv], do)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("in_hw,out_hw", [((288, 384), (240, 320)), ((384, 512), (480, 640))])
def test_resize_gradient_matches_plain(cuda, gen, in_hw, out_hw):
    x = torch.rand((2, *in_hw), generator=gen, device=cuda)
    g = torch.rand((2, *out_hw), generator=gen, device=cuda)
    (got,) = _grads(lambda t: trsz.resize_planes(t, out_hw), [x], g)
    (want,) = _grads(lambda t: trsz.resize_planes_plain(t, out_hw), [x], g)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("c,h,w", MIDAS_CONV2_SHAPES, ids=["layer1", "layer2", "layer3", "layer4"])
def test_grouped_conv_gradients_match_plain(cuda, gen, c, h, w):
    """dX is one more K4 launch (the transposed, flipped weight), dW the plain im2col product."""
    x, k = _grouped_inputs(gen, 2, c, h, w, 32, torch.float32, cuda)
    dy = torch.randn(x.shape, generator=gen, device=cuda)
    before = tgc.grouped_conv3x3.launches
    got = _grads(lambda a, b: tgc.grouped_conv3x3(a, b, 32), [x, k], dy)
    assert tgc.grouped_conv3x3.launches == before + 2
    want = _grads(lambda a, b: tgc.grouped_conv3x3_plain(a, b, 32), [x, k], dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,hw,per_step", [
    ("MiDaS_small", (192, 256), {"multi_head_attention": 0, "fused_preprocess": 1, "resize_planes": 1,
                                 "grouped_conv3x3": 0, "linear": 0}),
    ("MiDaS", (192, 256), {"multi_head_attention": 0, "fused_preprocess": 1, "resize_planes": 1,
                           "grouped_conv3x3": 60, "linear": 0})])
def test_train_step_on_the_card_holds_the_cpu(cuda, name, hw, per_step):
    """One train step of a full-width family on the card (its kernels and
    their Functions) against the same weights on the CPU: the
    loss within 1e-3 abs-rel, and the gradient, every trainable tensor as
    one vector, within 1e-3 of the CPU's largest value; each tensor within
    2.5e-2 of its own largest value from the float64 gradient (on random
    weights sound f32 gradients land MiDaS tensors up to 7.4e-3 off, TF32
    up to 9.6e-2: tools/train_grad_precision.py)."""
    import warnings

    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.train.data import TrainingApply, synthetic_pairs
    from depth_estimation_tpu_torch.train.step import (float64_gradients, make_optimizer, make_train_step,
                                                      trainable_tensors)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = DepthEstimator(name, seed=0, verbose=False)
    img, gt = next(synthetic_pairs(1, *hw, seed=2))
    img, gt = torch.from_numpy(img[None]), torch.from_numpy(gt[None])
    ref = float64_gradients(TrainingApply(est.model, est.preprocess_cfg), img, gt)[1]
    out = {}
    for device in ("cuda", "cpu"):
        model = DepthEstimator(name, params={k: v.cpu() for k, v in est.model.state_dict().items()},
                               verbose=False, device=device).model
        step = make_train_step(TrainingApply(model, est.preprocess_cfg), make_optimizer(model))
        kernels.reset_launch_counts()
        loss = float(step(img.to(device), gt.to(device)))
        out[device] = loss, {k: t.grad.float().cpu() for k, t in trainable_tensors(model).items()}
        if device == "cuda":
            assert kernels.launch_counts() == per_step
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) / abs(lc) < 1e-3
    top = max(float(g.abs().max()) for g in gc.values())
    assert top > 0
    for k, g in gc.items():
        err = float((gg[k] - g).abs().max())
        assert err / top < 1e-3 and (err == 0 or float(g.abs().max()) > 0), k
    for k, g64 in ref.items():
        err = float((gg[k].double() - g64).abs().max())
        assert err <= 2.5e-2 * float(g64.abs().max()), (k, err / float(g64.abs().max()))


# -- the kernels as operators, and an exported program on the card -----------------------------------


def _op_cases(gen, cuda):
    """(operator, args, plain version of the same args) for each kernel and route."""
    qkv = torch.randn((1, 77, 3, 2, 64), generator=gen, device=cuda).permute(2, 0, 3, 1, 4)
    kv = torch.randn((1, 150, 2, 2, 64), generator=gen, device=cuda).permute(2, 0, 3, 1, 4)
    imgs = torch.randint(0, 256, (2, 40, 56, 3), generator=gen, device=cuda, dtype=torch.uint8)
    planes = torch.rand((2, 24, 32), generator=gen, device=cuda)
    depth = 600 * planes - 100  # the u8 route's wrap-around both ways
    x, k = _grouped_inputs(gen, 1, 64, 9, 11, 8, torch.float32, cuda)
    pre = (imgs, [24, 32], list(DPT_PREPROCESS.mean), list(DPT_PREPROCESS.std), True, "cubic")
    lin = (torch.randn((2, 77, 64), generator=gen, device=cuda), torch.randn((96, 64), generator=gen, device=cuda),
           torch.randn((96,), generator=gen, device=cuda))
    return {
        "attention": (torch.ops.depth_tpu_torch.attention, (qkv[0], qkv[1], qkv[2]), tatt.attention_plain),
        "attention_nk": (torch.ops.depth_tpu_torch.attention, (qkv[0], kv[0], kv[1]), tatt.attention_plain),
        "preprocess_window": (torch.ops.depth_tpu_torch.preprocess,  # output rows 9 … 19 from rows 14 … 32
                              (imgs[:, 14:33].contiguous(), *pre[1:], [9, 20, 40, 14]), trsz.preprocess_plain),
        "resize_window": (torch.ops.depth_tpu_torch.resize_planes,  # output rows 10 … 29 from rows 4 … 19
                          (planes[:, 4:20].contiguous(), [40, 56], "cubic", False, "f32", [10, 30, 24, 4]),
                          trsz.resize_planes_plain),
        "preprocess": (torch.ops.depth_tpu_torch.preprocess, pre, trsz.preprocess_plain),
        "resize_f32": (torch.ops.depth_tpu_torch.resize_planes, (planes, [40, 56], "cubic", False, "f32"),
                       trsz.resize_planes_plain),
        "resize_u8": (torch.ops.depth_tpu_torch.resize_planes, (depth, [40, 56], "cubic", False, "u8"),
                      trsz.resize_planes_plain),
        "grouped_conv3x3": (torch.ops.depth_tpu_torch.grouped_conv3x3, (x, k, 8), tgc.grouped_conv3x3_plain),
        "linear": (torch.ops.depth_tpu_torch.linear, (*lin[:3], False), tlin.linear_plain),
        "linear_gelu": (torch.ops.depth_tpu_torch.linear, (*lin[:3], True), tlin.linear_plain),
    }


OP_CASES = ("attention", "attention_nk", "preprocess", "preprocess_window", "resize_f32", "resize_window",
            "resize_u8", "grouped_conv3x3", "linear", "linear_gelu")


@pytest.mark.parametrize("case", OP_CASES)
def test_operator_cuda_implementation_matches_plain(cuda, gen, case):
    """Each operator on CUDA tensors launches its kernel once (counted) and
    holds its plain version on the same inputs; u8 bytes may part only where
    the f32 map lies within 1e-3 of an integer."""
    from depth_estimation_tpu_torch.ops import kernels

    op, args, plain = _op_cases(gen, cuda)[case]
    kernels.reset_launch_counts()
    got = op(*args)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 1
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous()
    if case == "resize_u8":
        f32 = trsz.resize_planes_plain(*args[:4])
        near = (f32 - f32.round()).abs() < 1e-3
        assert not ((got != want) & ~near).any()
    else:  # the kernels' tolerances of the tests above
        atol, rtol = {"attention": (2e-5, 1e-4), "attention_nk": (2e-5, 1e-4), "grouped_conv3x3": (1e-4, 1e-4),
                      "linear": (1e-5, 1e-5), "linear_gelu": (1e-5, 1e-5)}.get(case, (3e-5, 0))
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", OP_CASES)
def test_operator_opcheck_on_cuda(cuda, gen, case):
    """``torch.library.opcheck`` on CUDA tensors: schema, autograd
    registration, the fake implementation against the CUDA one, AOT tracing."""
    op, args, _ = _op_cases(gen, cuda)[case]
    if case in ("attention", "attention_nk", "resize_f32", "resize_window", "grouped_conv3x3", "linear",
                "linear_gelu"):  # with a gradient
        args = tuple(a.detach().requires_grad_() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                     for a in args)
    result = torch.library.opcheck(op.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_train_step_gradient_is_the_same_every_call(cuda):
    """Two train steps of a tiny DPT (64-wide heads) from the same weights on
    the same u8 batch give bitwise equal gradients (lr 0, so the weights do
    not move): cuDNN's deterministic algorithms and the upsampling's matrix
    backward (ATen's bilinear backward and some cuDNN backward algorithms
    add with atomics)."""
    from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
    from depth_estimation_tpu_torch.train.data import TrainingApply
    from depth_estimation_tpu_torch.train.step import make_optimizer, make_train_step, trainable_tensors

    cfg = DPTConfig(embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
                    features=32, img_size=64, non_negative=False)
    g = torch.Generator().manual_seed(0)
    model = DPT(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    model.to(cuda)
    step = make_train_step(TrainingApply(model, DPT_PREPROCESS), make_optimizer(model, lr=0.0, weight_decay=0.0))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 240, 320, 3), np.uint8)).to(cuda)
    gt = torch.from_numpy(rng.random((2, 240, 320), np.float32) + 0.5).to(cuda)
    grads = []
    for _ in range(2):
        loss = step(imgs, gt)
        grads.append({k: t.grad.clone() for k, t in trainable_tensors(model).items()})
    assert torch.isfinite(loss)
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0]), \
        [k for k in grads[0] if not torch.equal(grads[0][k], grads[1][k])][:5]


def test_exported_tiny_dpt_round_trip_on_the_card(cuda, tmp_path):
    """A tiny DPT with 64-wide heads (K1's width) exported on the card, saved,
    loaded from disk: within max-scaled 1e-6 of the live program, K1 once a
    block, K2 1, K3 1 inside one loaded call."""
    import warnings

    from depth_estimation_tpu_torch import registry
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.utils.export import export_frame_program, load_frame_program

    cfg = DPTConfig(embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
                    features=32, img_size=64)
    registry.register(registry.ModelEntry("DPT_Tiny_cuda_export_test", lambda: DPT(cfg), DPT_PREPROCESS))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = DepthEstimator("DPT_Tiny_cuda_export_test", verbose=False)
    path = tmp_path / "tiny.pt2"
    path.write_bytes(export_frame_program(est, (120, 160)))
    fn = load_frame_program(path)
    img = np.random.default_rng(0).integers(0, 256, (120, 160, 3), np.uint8)
    kernels.reset_launch_counts()
    got = fn(est.params, img)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"multi_head_attention": 4, "fused_preprocess": 1, "resize_planes": 1,
                                       "grouped_conv3x3": 0, "linear": 4 * 4 + 4}
    want = est.predict(img)
    assert got.device.type == "cuda" and np.isfinite(want).all()
    assert float(np.abs(got.cpu().numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())
    with pytest.raises(ValueError, match="exported for cuda"):
        fn({k: v.cpu() for k, v in est.params.items()}, img)


def _ssi_loss_numpy(pred, gt, trim=0.2):
    """``ssi_loss`` without a mask in float64 numpy, the cut by ``np.quantile``."""
    pred, gt = pred.astype(np.float64), gt.astype(np.float64)
    n = pred[0].size
    sp, sg = pred.sum(axis=(1, 2)), gt.sum(axis=(1, 2))
    spp, spg = (pred * pred).sum(axis=(1, 2)), (pred * gt).sum(axis=(1, 2))
    det = spp * n - sp * sp
    s, t = (spg * n - sp * sg) / det, (spp * sg - sp * spg) / det
    err = np.abs(pred * s[:, None, None] + t[:, None, None] - gt).reshape(len(pred), -1)
    cut = np.quantile(err, 1.0 - trim, axis=1, keepdims=True)
    return float((np.where(err <= cut, err, 0.0).sum(axis=1) / (n * (1.0 - trim))).mean())


@pytest.mark.parametrize("shape", [(1026, 128, 128), (1, 4200, 4096)], ids=["batch", "one_row"])
def test_ssi_loss_on_more_than_2_24_values_on_the_card(cuda, shape):
    """``ssi_loss`` on the card over more than 2^24 values, in a batch of
    maps and in one map, against numpy's quantile in float64: the
    ``torch.quantile`` it once used refuses such inputs."""
    from depth_estimation_tpu_torch.train.losses import ssi_loss

    rng = np.random.default_rng(5)
    pred = rng.random(shape, dtype=np.float32)
    gt = (2.0 * pred + 0.5 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    assert pred.size > 2 ** 24
    got = float(ssi_loss(torch.from_numpy(pred).to(cuda), torch.from_numpy(gt).to(cuda)))
    assert got == pytest.approx(_ssi_loss_numpy(pred, gt), rel=1e-4)


# -- the linear layers' f32 GEMM kernel (csrc/linear.cu) ------------------------------------------------

# (K, N, GELU) of each linear layer of the two DPT families (qkv, proj, fc1, fc2, readout)
LINEAR_LAYERS = {"large_qkv": (1024, 3072, False), "large_proj": (1024, 1024, False),
                 "large_fc1": (1024, 4096, True), "large_fc2": (4096, 1024, False),
                 "large_readout": (2048, 1024, True), "hybrid_qkv": (768, 2304, False),
                 "hybrid_proj": (768, 768, False), "hybrid_fc1": (768, 3072, True), "hybrid_fc2": (3072, 768, False),
                 "hybrid_readout": (1536, 768, True)}
# rows: one row, the sp shares of 769 tokens over 4 and 2, one frame, the stream's microbatch, the servers' batch
LINEAR_ROWS = (1, 193, 385, 769, 3076, 6152)


def _linear_case(gen, device, m, k, n, scale=30.0):
    """×30-scaled inputs, as K1's and K4's large cases: products of 900
    times the unit ones, where TF32's rounding shows."""
    x = torch.randn((m, k), generator=gen, device=device) * scale
    w = torch.randn((n, k), generator=gen, device=device) * (scale / k ** 0.5)
    return x, w, torch.randn((n,), generator=gen, device=device)


def _scaled_err(got, exact):
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def _assert_f32_error(x, w, b, gelu):
    """One launch, the same bits twice, and within twice f32's own distance
    from the float64 result (max-scaled)."""
    before = tlin.linear.launches
    got = tlin.linear(x, w, b, gelu)
    again = tlin.linear(x, w, b, gelu)
    torch.cuda.synchronize()
    assert tlin.linear.launches == before + 2
    assert got.shape == (*x.shape[:-1], w.shape[0]) and got.dtype == torch.float32
    assert torch.equal(got, again)
    exact = tlin.linear_plain(x.double(), w.double(), None if b is None else b.double(), gelu)
    err, f32 = _scaled_err(got, exact), _scaled_err(tlin.linear_plain(x, w, b, gelu), exact)
    assert err <= max(2 * f32, 1e-6), (err, f32)
    return err


@pytest.mark.parametrize("m", LINEAR_ROWS)
@pytest.mark.parametrize("layer", list(LINEAR_LAYERS))
def test_linear_kernel_holds_float64_as_f32_does(cuda, gen, layer, m):
    """Every linear layer of both families at every row count the cells and
    the sp shares run, against float64 (+ exact GELU where the layer has it)."""
    k, n, gelu = LINEAR_LAYERS[layer]
    _assert_f32_error(*_linear_case(gen, cuda, m, k, n), gelu)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("layer", [key for key in LINEAR_LAYERS if not key.endswith("readout")])
def test_linear_kernel_at_tensor_parallel_shards(cuda, gen, layer, tp):
    """A tp rank's shard at one frame: qkv and fc1 cut on N (column-parallel),
    proj and fc2 on K and without a bias (row-parallel: the bias is added once
    after the all-reduce)."""
    k, n, gelu = LINEAR_LAYERS[layer]
    row_parallel = layer.endswith(("proj", "fc2"))
    k, n = (k // tp, n) if row_parallel else (k, n // tp)
    x, w, b = _linear_case(gen, cuda, 769, k, n)
    _assert_f32_error(x, w, None if row_parallel else b, gelu)


def test_linear_kernel_error_is_f32s_not_tf32s(cuda, gen):
    """At fc1's shape over the stream's microbatch: one TF32 pass lands some
    100 times further from float64 than the kernel does."""
    x, w, b = _linear_case(gen, cuda, 3076, 1024, 4096)
    err = _assert_f32_error(x, w, b, True)
    exact = tlin.linear_plain(x.double(), w.double(), b.double(), True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _scaled_err(tlin.linear_plain(x, w, b, True), exact)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert tf32 > 100 * err, (tf32, err)


def test_linear_kernel_drops_the_remainder_of_a_weight_updated_in_place(cuda, gen):
    """The cached w_lo (and its tensor maps) follow the weight: after an
    in-place update and after ``load_state_dict`` the kernel holds the plain
    version on the new weight."""
    x, w, b = _linear_case(gen, cuda, 769, 1024, 1024, scale=1.0)
    layer = torch.nn.Linear(1024, 1024, device=cuda)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    for update in (lambda: layer.weight.mul_(-0.5),
                   lambda: layer.load_state_dict({"weight": w * 3, "bias": b})):
        first = tlin.linear(x, layer.weight, layer.bias)
        torch.testing.assert_close(first, tlin.linear_plain(x, layer.weight, layer.bias), atol=1e-5, rtol=1e-5)
        with torch.no_grad():
            update()
        got = tlin.linear(x, layer.weight, layer.bias)
        torch.testing.assert_close(got, tlin.linear_plain(x, layer.weight, layer.bias), atol=1e-5, rtol=1e-5)
        assert not torch.allclose(got, first)


def test_linear_refuses_operands_the_kernel_cannot_take(cuda, gen):
    """bf16 (the models send it to F.linear by dtype), a K that is not a
    multiple of 32, an N that is not of 8, an x that is not 16-byte aligned
    and a weight on the CPU raise ValueError and launch nothing."""
    x, w, b = _linear_case(gen, cuda, 769, 1024, 1024, scale=1.0)
    flat = torch.empty(769 * 1024 + 1, device=cuda)
    cases = [(x.bfloat16(), w.bfloat16(), b.bfloat16()), (x[:, :1000].contiguous(), w[:, :1000].contiguous(), b),
             (x, w[:1020].contiguous(), b[:1020]), (flat[1:].view(769, 1024), w, b), (x, w.cpu(), b)]
    for args in cases:
        launches = tlin.linear.launches
        with pytest.raises(ValueError, match="linear kernel takes float32"):
            tlin.linear(*args, gelu=True)
        assert tlin.linear.launches == launches


def test_linear_copies_a_non_contiguous_x(cuda, gen):
    """A transposed-back x is made contiguous and launches the kernel once;
    an x of no rows gives an empty output and no launch."""
    x, w, b = _linear_case(gen, cuda, 769, 1024, 1024, scale=1.0)
    before = tlin.linear.launches
    got = tlin.linear(x.t().contiguous().t(), w, b, gelu=True)
    assert tlin.linear.launches == before + 1
    torch.testing.assert_close(got, tlin.linear_plain(x, w, b, gelu=True), atol=1e-5, rtol=1e-5)
    empty = tlin.linear(x[:0], w, b)
    assert empty.shape == (0, 1024) and tlin.linear.launches == before + 1


def test_linear_gradients_match_plain(cuda, gen):
    """The operator's output carries linear_backward_plain's dX, dW and db,
    with the GELU's derivative, as autograd of the plain version gives them."""
    x, w, b = _linear_case(gen, cuda, 385, 1024, 4096, scale=1.0)
    dy = torch.randn((385, 4096), generator=gen, device=cuda)
    before = tlin.linear.launches
    got = _grads(lambda *t: tlin.linear(*t, gelu=True), [x, w, b], dy)
    assert tlin.linear.launches == before + 1  # the backward launches nothing
    want = _grads(lambda *t: tlin.linear_plain(*t, gelu=True), [x, w, b], dy)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,per_program", [("DPT_Large", 100), ("DPT_Hybrid", 50)])
def test_linear_launches_on_a_dpt_program(cuda, name, per_program):
    """Every linear layer of a DPT frame program takes the kernel: 24 (12)
    blocks × qkv, proj, fc1, fc2 and 4 (2) readout projections; the bf16
    program launches none. The weights-as-argument program, given a fresh
    ``est.params`` each call, finds the weights' cached remainders: no entry
    is made again."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops import kernels

    frame = np.random.default_rng(0).integers(0, 256, (480, 640, 3), np.uint8)
    for dtype, launches in (("float32", per_program), ("bfloat16", 0)):
        est = DepthEstimator(name, seed=0, device="cuda", dtype=dtype, verbose=False)
        est.predict(frame)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        est.predict(frame)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["linear"] == launches
        if dtype == "float32":
            qkv = "pretrained.model.blocks.0.attn.qkv.weight"
            entry = tlin._weight_entry(est.model.state_dict()[qkv])
            entries = {key: dict(views) for key, (_, views) in tlin._WEIGHTS.items()}
            assert len(entries) >= per_program and tlin._weight_entry(est.params[qkv]) is entry
            fn = est.frame_fn(frame.shape[:2])
            got = [fn(est.params, frame) for _ in range(2)]
            assert torch.equal(got[0], got[1])
            assert {key: dict(views) for key, (_, views) in tlin._WEIGHTS.items()} == entries
        del est
        torch.cuda.empty_cache()
