"""The port's kernels' plain PyTorch versions against the JAX package's
kernels (Pallas in interpret mode) and their XLA forms, on the CPU. The CUDA
kernels themselves are tested against these plain versions in
tests/test_torch_cuda.py, on a GPU."""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depth_estimation_tpu.config import DPT_PREPROCESS, SMALL_PREPROCESS
from depth_estimation_tpu.ops.pallas.attention import _attention_xla
from depth_estimation_tpu.ops.pallas.attention import multi_head_attention as jax_mha
from depth_estimation_tpu.ops.pallas.grouped_conv import grouped_conv3x3_pallas
from depth_estimation_tpu.ops.pallas.resize import pallas_preprocess, pallas_resize2d
from depth_estimation_tpu.ops.postprocess import wraparound_u8_jax
from depth_estimation_tpu.ops.preprocess import compute_resize_shape
from depth_estimation_tpu_torch.ops.kernels import attention as tatt
from depth_estimation_tpu_torch.ops.kernels import build
from depth_estimation_tpu_torch.ops.kernels import dense as tlin
from depth_estimation_tpu_torch.ops.kernels import grouped_conv as tgc
from depth_estimation_tpu_torch.ops.kernels import resize as trsz


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_attention_plain_matches_xla_and_pallas(rng):
    q, k, v = _qkv(rng, (2, 4, 577, 64))
    got = tatt.attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, np.asarray(_attention_xla(q, k, v, 64 ** -0.5)), atol=2e-5, rtol=1e-4)
    pallas = np.asarray(jax_mha(q, k, v, use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)


def test_attention_plain_bf16_matches_xla(rng):
    import jax.numpy as jnp

    q, k, v = _qkv(rng, (1, 2, 97, 64))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tatt.attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(_attention_xla(jq, jk, jv, 64 ** -0.5).astype(jnp.float32))
    # both round the probabilities and the output to bf16 (2**-8 relative)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2, rtol=1e-2)


def test_attention_wrapper_takes_plain_on_cpu(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 2, 65, 32)))
    before = tatt.multi_head_attention.launches
    out = tatt.multi_head_attention(q, k, v)
    assert tatt.multi_head_attention.launches == before
    torch.testing.assert_close(out, tatt.attention_plain(q, k, v), rtol=0, atol=0)


def test_attention_wrapper_refuses_other_devices():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        tatt.multi_head_attention(q, q, q)


@pytest.mark.parametrize("cfg", [DPT_PREPROCESS, SMALL_PREPROCESS], ids=["dpt", "small"])
def test_preprocess_plain_matches_pallas(rng, cfg):
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    out_hw = compute_resize_shape(120, 160, cfg)
    ref = np.asarray(pallas_preprocess(img, out_hw, tuple(cfg.mean), tuple(cfg.std), interpret=True))
    got = trsz.preprocess_plain(torch.from_numpy(img)[None], out_hw, cfg.mean, cfg.std)
    assert got.shape == (1, 3, *out_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=3e-5)
    before = trsz.fused_preprocess.launches
    wrapped = trsz.fused_preprocess(torch.from_numpy(img)[None], out_hw, cfg.mean, cfg.std)
    assert trsz.fused_preprocess.launches == before
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((96, 128), (120, 160)), ((48, 64), (60, 80)), ((120, 160), (96, 128))])
def test_resize_plain_matches_pallas(rng, in_hw, out_hw):
    d = rng.random(in_hw).astype(np.float32)
    ref = np.asarray(pallas_resize2d(d, out_hw, interpret=True))
    got = trsz.resize_planes_plain(torch.from_numpy(d)[None], out_hw)
    assert got.shape == (1, *out_hw)
    np.testing.assert_allclose(got[0].numpy(), ref, atol=3e-5)
    before = trsz.resize_planes.launches
    torch.testing.assert_close(trsz.resize_planes(torch.from_numpy(d), out_hw), got[0], rtol=0, atol=0)
    assert trsz.resize_planes.launches == before


# K2 and K3 (csrc/resize.cu): the tiling's staged windows, and the kernel's
# two passes in f32 with its folded normalization and order of summation.

# (kernel, in_hw, out_hw): the main paths' shapes (DPT_Large, MiDaS)
_K23_MAIN = [("preprocess", (480, 640), (384, 512)), ("preprocess", (480, 640), (192, 256)),
             ("resize", (384, 512), (480, 640)), ("resize", (192, 256), (480, 640))]
_K23_RAGGED = [("preprocess", (7, 11), (5, 9)), ("preprocess", (3, 5), (7, 2)), ("preprocess", (50, 37), (96, 130)),
               ("resize", (3, 5), (7, 2)), ("resize", (5, 3), (2, 7)), ("resize", (41, 67), (300, 131)),
               ("resize", (24, 32), (48, 64))]


def _k23_walk_tiles(kernel, in_hw, out_hw, batch, method="cubic", align_corners=False, sms=132):
    """The kernel's steps 1-2 for every tile of ``tiling()``: the window from
    warp 0's min/max over the tile's row taps and column taps (a thread's
    output past the image copies the taps of its previous one), then the
    staged byte range [sb, se) of each row. Checks each against the
    tiling's room."""
    channels, itemsize = trsz._KERNELS[kernel]
    t = trsz.tiling(in_hw, out_hw, batch, sms, kernel, method, align_corners)
    (h_in, w_in), (h_out, w_out) = in_hw, out_hw
    h_idx, _ = trsz.band_taps(h_in, h_out, method, align_corners)
    w_idx, _ = trsz.band_taps(w_in, w_out, method, align_corners)
    kpix, row_bytes = channels * itemsize, w_in * channels * itemsize
    assert t["grid"] == (-(-w_out // t["tw"]), -(-h_out // t["th"]), batch)
    assert t["smem_bytes"] == 32 * t["th"] + t["rows"] * t["in_pitch"] + 4 * channels * t["th"] * t["mid_pitch"]
    assert t["smem_bytes"] <= 227 * 1024 and t["in_pitch"] % 16 == 0 and t["mid_pitch"] % 32 == t["tw"] // 4 % 32
    for r0 in range(0, h_out, t["th"]):
        rows = h_idx[r0:r0 + t["th"]]
        rlo, rhi = rows[:, 0].min(), rows[:, 3].max()
        assert rhi - rlo + 1 <= t["rows"] and (np.diff(rows, axis=1) >= 0).all()
        for c0 in range(0, w_out, t["tw"]):
            taps = w_idx[c0:c0 + t["tw"]]
            clo, chi = taps[:, 0].min(), taps[:, 3].max()
            nc = chi - clo + 1
            sb, se = (clo * kpix) & ~15, min(((chi + 1) * kpix + 15) & ~15, row_bytes)
            assert nc <= t["cols"] <= t["mid_pitch"] and se - sb <= t["in_pitch"]
            # every tap of the tile's rows and columns lies in the window, and
            # every byte the vertical pass reads lies in the staged range
            assert rlo <= rows.min() and rows.max() <= rhi and clo <= taps.min() and taps.max() <= chi
            assert clo * kpix - sb >= 0 and (chi + 1) * kpix - sb <= se - sb
            if row_bytes % 16 == 0:
                assert sb % 16 == 0 and se % 16 == 0
    return t


@pytest.mark.parametrize("kernel,in_hw,out_hw", _K23_MAIN, ids=["k2_dpt", "k2_midas", "k3_dpt", "k3_midas"])
@pytest.mark.parametrize("batch", [1, 4])
def test_k23_tiling_windows_at_main_shapes(kernel, in_hw, out_hw, batch):
    """At the main paths' shapes: every staged window holds its tile's taps
    within the tiling's room, a launch is one wave, and at batch 1 one of one
    to two blocks an SM (132 on the H100)."""
    t = _k23_walk_tiles(kernel, in_hw, out_hw, batch)
    assert t["blocks"] <= 132 * t["blocks_per_sm"]
    if batch == 1:
        assert 132 <= t["blocks"] <= 2 * 132


# K2's linear route: the detectors' inputs on the fused iris path (BlazeFace
# 128², BlazePose 256²), downscales of 3.75 × 5 and 1.875 × 2.5
_K2_DETECTORS = [((480, 640), (128, 128)), ((480, 640), (256, 256))]


@pytest.mark.parametrize("in_hw,out_hw", _K2_DETECTORS, ids=["blazeface", "blazepose"])
@pytest.mark.parametrize("batch", [1, 4])
def test_k2_linear_tiling_windows_at_detector_shapes(in_hw, out_hw, batch):
    """The downscales' windows (4-5× a tile's width) fit shared memory, a
    launch is one wave, and at batch 1 one of one to two blocks an SM."""
    t = _k23_walk_tiles("preprocess", in_hw, out_hw, batch, "linear")
    assert t["blocks"] <= 132 * t["blocks_per_sm"]
    if batch == 1:
        assert 132 <= t["blocks"] <= 2 * 132


@pytest.mark.parametrize("kernel,in_hw,out_hw", _K23_RAGGED)
def test_k23_tiling_windows_at_ragged_shapes(kernel, in_hw, out_hw):
    """Ragged shapes, several batches and SM counts; K3 also in linear with
    and without align_corners, K2 also in linear."""
    methods = [("cubic", False), ("linear", False)] + ([("linear", True)] if kernel == "resize" else [])
    for method, align_corners in methods:
        for batch, sms in ((1, 132), (3, 132), (1, 8)):
            _k23_walk_tiles(kernel, in_hw, out_hw, batch, method, align_corners, sms)


def _k23_horizontal_read_banks(kernel, in_hw, out_hw, batch=1):
    """For every warp read of the horizontal pass at ``tiling()``'s tiles:
    the most distinct words of the intermediate that fall on one bank. Lane
    tid makes outputs cb + k·tw/4 (cb = tid mod tw/4) of (channel, row) pair
    tid // (tw/4), then pairs 256/(tw/4) further on; tap j of output k reads
    word pair·mid_pitch + idx[k][j] - clo."""
    channels = trsz._KERNELS[kernel][0]
    t = trsz.tiling(in_hw, out_hw, batch, 132, kernel)
    w_idx, _ = trsz.band_taps(in_hw[1], out_hw[1])
    th, cs = t["th"], t["tw"] // 4
    worst = 0
    for c0 in range(0, out_hw[1], t["tw"]):
        tw = min(t["tw"], out_hw[1] - c0)
        clo = w_idx[c0:c0 + tw, 0].min()
        for r0 in range(0, out_hw[0], th):
            pairs = channels * min(th, out_hw[0] - r0)
            for tid in np.arange(trsz.THREADS).reshape(-1, 32):
                cb, pair0 = tid % cs, tid // cs
                for pair in (pair0 + step for step in range(0, pairs, trsz.THREADS // cs)):
                    ch, r = pair // (pairs // channels), pair % (pairs // channels)
                    for k in range(4):
                        live = (cb + k * cs < tw) & (pair < pairs)
                        col = c0 + np.where(live, cb + k * cs, 0)
                        for j in range(4):
                            words = ((ch * th + r) * t["mid_pitch"] + w_idx[col, j] - clo)[live]
                            if len(words):
                                worst = max(worst, np.bincount(np.unique(words) % 32).max())
    return worst


@pytest.mark.parametrize("kernel,in_hw,out_hw,most", [(*case, most) for case, most in zip(_K23_MAIN, (2, 2, 1, 1))],
                         ids=["k2_dpt", "k2_midas", "k3_dpt", "k3_midas"])
def test_k23_horizontal_reads_bank_conflicts(kernel, in_hw, out_hw, most):
    """K3's upscales read the intermediate without bank conflicts; K2's
    downscales by 1.25 and 2.5 span more than 32 words a warp row, so two
    words share a bank, no more (the mid pitch keeps a warp's two rows at
    K2-MiDaS's 64-wide tiles apart)."""
    assert _k23_horizontal_read_banks(kernel, in_hw, out_hw) == most


def test_k23_tiling_constants_match_the_source():
    """tiling() sizes what the kernel assumes: its threads a block, blocks an
    SM under __launch_bounds__, and tallest tile (one row tap a lane of warp 0)."""
    src = (build.CSRC / "resize.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kMinBlocks"]), int(consts["kMaxTileH"])) == (
        trsz.THREADS, trsz.MIN_BLOCKS, trsz.MAX_TILE_H)
    assert "__launch_bounds__(kThreads, kMinBlocks)" in src and trsz.MAX_TILE_H <= 32
    assert trsz.TILE_WIDTHS == (32, 64, 128)  # the kernel's column groups: 8, 16 or 32 lanes


def _fma(a, b, c):
    """f32 fused multiply-add: the product is exact in float64, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _k23_passes(x, in_hw, out_hw, method="cubic", align_corners=False):
    """The kernel's vertical then horizontal pass on x (B, H, W, C) f32, with
    its order of summation: w0·x0, then fma of taps 1, 2, 3."""
    h_idx, h_w = (torch.from_numpy(a) for a in trsz.band_taps(in_hw[0], out_hw[0], method, align_corners))
    w_idx, w_w = (torch.from_numpy(a) for a in trsz.band_taps(in_hw[1], out_hw[1], method, align_corners))
    h_idx, w_idx = h_idx.long(), w_idx.long()
    v = h_w[:, 0, None, None] * x[:, h_idx[:, 0]]
    for i in range(1, 4):
        v = _fma(h_w[:, i, None, None].expand_as(v), x[:, h_idx[:, i]], v)
    acc = w_w[:, 0, None] * v[:, :, w_idx[:, 0]]
    for j in range(1, 4):
        acc = _fma(w_w[:, j, None].expand_as(acc), v[:, :, w_idx[:, j]], acc)
    return acc  # (B, H_out, W_out, C)


def _k2_emulate(imgs, out_hw, mean, std, bgr=True, method="cubic"):
    acc = _k23_passes(imgs.float(), imgs.shape[1:3], out_hw, method)
    acc = acc.flip(-1) if bgr else acc
    scale, bias = (torch.tensor(v, dtype=torch.float32) for v in trsz.normalize_affine(mean, std))
    return _fma(acc, scale.expand_as(acc), bias.expand_as(acc)).permute(0, 3, 1, 2)


def _k3_emulate(planes, out_hw, method="cubic", align_corners=False, output="f32"):
    out = _k23_passes(planes[..., None], planes.shape[1:], out_hw, method, align_corners)[..., 0]
    return (out.double().trunc().long() & 255).to(torch.uint8) if output == "u8" else out


@pytest.mark.parametrize("cfg,in_hw", [(DPT_PREPROCESS, (120, 160)), (SMALL_PREPROCESS, (120, 160)),
                                       (SMALL_PREPROCESS, (480, 640))], ids=["dpt", "small", "small_480x640"])
def test_k2_two_pass_arithmetic_holds_plain_and_pallas(rng, cfg, in_hw):
    img = rng.integers(0, 256, (*in_hw, 3), np.uint8)
    out_hw = compute_resize_shape(*in_hw, cfg)
    got = _k2_emulate(torch.from_numpy(img)[None], out_hw, cfg.mean, cfg.std)
    plain = trsz.preprocess_plain(torch.from_numpy(img)[None], out_hw, cfg.mean, cfg.std)
    torch.testing.assert_close(got, plain, atol=3e-5, rtol=0)
    ref = np.asarray(pallas_preprocess(img, out_hw, tuple(cfg.mean), tuple(cfg.std), interpret=True))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=3e-5, rtol=0)


def test_k2_two_pass_arithmetic_at_dpt_main_shape(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 480, 640, 3), np.uint8))
    got = _k2_emulate(imgs, (384, 512), DPT_PREPROCESS.mean, DPT_PREPROCESS.std)
    plain = trsz.preprocess_plain(imgs, (384, 512), DPT_PREPROCESS.mean, DPT_PREPROCESS.std)
    torch.testing.assert_close(got, plain, atol=3e-5, rtol=0)


@pytest.mark.parametrize("out_hw,mean,std", [((128, 128), (0.5,) * 3, (0.5,) * 3), ((256, 256), (0.0,) * 3, (1.0,) * 3)],
                         ids=["blazeface", "blazepose"])
def test_k2_linear_two_pass_arithmetic_at_detector_shapes(rng, out_hw, mean, std):
    """K2's linear route at the detectors' inputs: its two passes (2 taps a
    row, padded with zero weights) and folded normalization against the
    plain version and the Pallas kernel in linear mode."""
    img = rng.integers(0, 256, (480, 640, 3), np.uint8)
    got = _k2_emulate(torch.from_numpy(img)[None], out_hw, mean, std, method="linear")
    plain = trsz.preprocess_plain(torch.from_numpy(img)[None], out_hw, mean, std, method="linear")
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
    ref = np.asarray(pallas_preprocess(img, out_hw, mean, std, method="linear", interpret=True))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw,method,align_corners", [
    ((96, 128), (120, 160), "cubic", False), ((120, 160), (96, 128), "cubic", False),
    ((192, 256), (480, 640), "cubic", False), ((24, 32), (48, 64), "linear", True), ((5, 3), (2, 7), "cubic", False)])
def test_k3_two_pass_arithmetic_holds_plain_and_pallas(rng, in_hw, out_hw, method, align_corners):
    d = rng.random(in_hw).astype(np.float32)
    got = _k3_emulate(torch.from_numpy(d)[None], out_hw, method, align_corners)
    plain = trsz.resize_planes_plain(torch.from_numpy(d)[None], out_hw, method, align_corners)
    torch.testing.assert_close(got, plain, atol=3e-5, rtol=0)
    ref = np.asarray(pallas_resize2d(d, out_hw, method, align_corners, interpret=True))
    np.testing.assert_allclose(got[0].numpy(), ref, atol=3e-5, rtol=0)


def _assert_u8_agrees(got, want, f32):
    """Bytes may differ only where the f32 map lies within 1e-3 of an integer
    (the rule of tests/test_torch_estimator.py)."""
    got, want, f32 = np.asarray(got), np.asarray(want), np.asarray(f32)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differ = got != want
    near_int = np.abs(f32 - np.round(f32)) < 1e-3
    assert not (differ & ~near_int).any(), f"{int((differ & ~near_int).sum())} bytes differ away from an integer"


@pytest.mark.parametrize("in_hw,out_hw", [((96, 128), (120, 160)), ((48, 64), (120, 160)), ((120, 160), (96, 128))])
def test_k3_u8_route_matches_jax_wraparound(rng, in_hw, out_hw):
    """The u8 route's plain version against JAX's wrap-around cast of the
    Pallas resize, on depth-like values from -50 to 550 (negatives and
    values past 255 wrap); and the kernel's (int)trunc(v) & 255 epilogue on
    its own two passes."""
    d = (rng.random(in_hw) * 600 - 50).astype(np.float32)
    f32 = np.asarray(pallas_resize2d(d, out_hw, interpret=True))
    want = np.asarray(wraparound_u8_jax(f32))
    plain = trsz.resize_planes_plain(torch.from_numpy(d), out_hw, output="u8")
    assert plain.dtype == torch.uint8 and plain.shape == out_hw
    _assert_u8_agrees(plain.numpy(), want, f32)
    before = trsz.resize_planes.launches
    torch.testing.assert_close(trsz.resize_planes(torch.from_numpy(d), out_hw, output="u8"), plain, rtol=0, atol=0)
    assert trsz.resize_planes.launches == before
    _assert_u8_agrees(_k3_emulate(torch.from_numpy(d)[None], out_hw, output="u8")[0].numpy(), want, f32)


# The arithmetic of K1's float32 route (csrc/attention.cu): 3xTF32 products
# on the tensor cores, and the fragment layouts of mma.sync.m16n8k8 with the
# permuted reduction index that keeps P in registers.


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 to TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits' range to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the mma reads of an f32 operand: its low 13 bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_a(x):
    """The kernel's split of Q and P: hi rounded, the rest truncated by the mma."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def _split_b(x):
    """The kernel's split of K and V: hi truncated by the mma, and the rest."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def _matmul_3xtf32(a, b):
    (a_hi, a_lo), (b_hi, b_lo) = _split_a(a), _split_b(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _matmul_1xtf32(a, b):
    return tf32_round(a) @ tf32_round(b)


def _attention_tf32(q, k, v, matmul):
    probs = torch.softmax(matmul(q, k.transpose(-1, -2)) * 64 ** -0.5, dim=-1)
    return matmul(probs, v)


def test_tf32_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, 1 + one_ulp / 4, 1 + 3 * one_ulp / 4, -(1 + one_ulp / 2), 3.0, 0.0])
    want = torch.tensor([1 + one_ulp, 1.0, 1 + one_ulp, -(1 + one_ulp), 3.0, 0.0])
    torch.testing.assert_close(tf32_round(x), want, rtol=0, atol=0)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    assert ((tf32_round(y) - y).abs() <= y.abs() * 2.0 ** -11).all()
    assert ((tf32_trunc(y) - y).abs() <= y.abs() * 2.0 ** -10).all()
    # hi + lo keeps some 21 of f32's 24 bits for either split
    for hi, lo in (_split_a(y), _split_b(y)):
        assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
        assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -20).all()


def test_3xtf32_attention_holds_plain_and_xla(rng):
    q, k, v = _qkv(rng, (1, 2, 769, 64))
    got = _attention_tf32(*map(torch.from_numpy, (q, k, v)), _matmul_3xtf32).numpy()
    plain = tatt.attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(_attention_xla(q, k, v, 64 ** -0.5)), atol=2e-5, rtol=1e-4)


def test_one_pass_tf32_attention_misses_the_tolerance(rng):
    """Why the kernel takes three passes: one TF32 pass is some 3e-4 off."""
    q, k, v = _qkv(rng, (1, 2, 769, 64))
    got = _attention_tf32(*map(torch.from_numpy, (q, k, v)), _matmul_1xtf32).numpy()
    plain = tatt.attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    assert not np.allclose(got, plain, atol=2e-5, rtol=1e-4)
    assert np.abs(got - plain).max() > 1e-4


def test_3xtf32_attention_large_logits_as_close_as_f32(rng):
    """q scaled by 30 (logits of std 30): f32 itself is some 4e-5 from the
    exact result there, so 3xTF32 is held against float64 within twice the
    plain f32 version's distance, as tests/test_torch_cuda.py holds the kernel."""
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 2, 769, 64)))
    q = q * 30
    exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8, dim=-1) @ v.double()
    plain_err = (tatt.attention_plain(q, k, v).double() - exact).abs().max().item()
    got_err = (_attention_tf32(q, k, v, _matmul_3xtf32).double() - exact).abs().max().item()
    assert got_err <= max(2 * plain_err, 2e-5)


_LANE = torch.arange(32)
_G, _T = _LANE >> 2, _LANE & 3


def _mma_m16n8k8(a, b, c):
    """One warp's mma.sync.m16n8k8 on per-lane fragments: a (32, 4), b (32, 2),
    c (32, 4), laid out as the PTX ISA gives them for .tf32 (g = lane >> 2,
    t = lane & 3)."""
    am = torch.zeros((16, 8), dtype=a.dtype)
    am[_G, _T], am[_G + 8, _T], am[_G, _T + 4], am[_G + 8, _T + 4] = a.unbind(1)
    bm = torch.zeros((8, 8), dtype=b.dtype)
    bm[_T, _G], bm[_T + 4, _G] = b.unbind(1)
    d = am @ bm
    return c + torch.stack([d[_G, 2 * _T], d[_G, 2 * _T + 1], d[_G + 8, 2 * _T], d[_G + 8, 2 * _T + 1]], 1)


def _from_c_fragments(frags):
    """(8 n8 tiles, 32 lanes, 4) C fragments back into a 16×64 matrix."""
    out = torch.zeros((16, 64), dtype=frags.dtype)
    for j, c in enumerate(frags):
        col = 8 * j + 2 * _T
        out[_G, col], out[_G, col + 1], out[_G + 8, col], out[_G + 8, col + 1] = c.unbind(1)
    return out


def test_mma_fragments_and_permuted_p_give_one_warps_tile(rng):
    """One warp's 16 Q rows against one 64-key tile, with the kernel's index
    arithmetic: S = Q·Kᵀ with d permuted across each pair of k-chunks (2c,
    2c+1), so that a lane's mma indices t and t+4 are d = 16c + 4t and + 1 in
    chunk 2c and + 2 and + 3 in chunk 2c+1 (one 16-byte read of Q and of
    K[key 8j+g]); then O = P·V with P taken from S's C fragments as a0 = c0,
    a1 = c2, a2 = c1, a3 = c3 and V read as b0 = V[key 2t][d g],
    b1 = V[key 2t+1][d g]."""
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 64))) for n in (16, 64, 64))
    s = torch.zeros((8, 32, 4), dtype=torch.float64)
    for j in range(8):
        for kc in range(8):
            d = 16 * (kc // 2) + 4 * _T + 2 * (kc % 2)  # mma index t; index t+4 is d + 1
            a = torch.stack([q[_G, d], q[_G + 8, d], q[_G, d + 1], q[_G + 8, d + 1]], 1)
            s[j] = _mma_m16n8k8(a, torch.stack([k[8 * j + _G, d], k[8 * j + _G, d + 1]], 1), s[j])
    torch.testing.assert_close(_from_c_fragments(s), q @ k.T, rtol=1e-12, atol=1e-12)

    p = torch.softmax(_from_c_fragments(s), dim=-1)
    p_frags = torch.stack([torch.stack([p[_G, 8 * j + 2 * _T], p[_G, 8 * j + 2 * _T + 1], p[_G + 8, 8 * j + 2 * _T],
                                        p[_G + 8, 8 * j + 2 * _T + 1]], 1) for j in range(8)])
    o = torch.zeros((8, 32, 4), dtype=torch.float64)
    for j in range(8):
        a = p_frags[j][:, [0, 2, 1, 3]]
        for dn in range(8):
            key, d = 8 * j + 2 * _T, 8 * dn + _G
            o[dn] = _mma_m16n8k8(a, torch.stack([v[key, d], v[key + 1, d]], 1), o[dn])
    torch.testing.assert_close(_from_c_fragments(o), p @ v, rtol=1e-12, atol=1e-12)

    # the identity behind it: permuting the keys within each 8-key chunk of P and of V
    perm = (torch.arange(64) // 8 * 8 + torch.tensor([0, 2, 4, 6, 1, 3, 5, 7]).repeat(8))
    torch.testing.assert_close(p[:, perm] @ v[perm], p @ v, rtol=1e-12, atol=1e-12)


def test_attention_alignment_rule_of_the_f32_route():
    """The f32 kernel's 16-byte copies need 16-byte aligned pointers and
    (batch, head, row) strides that are multiples of 4 elements: the ViT's
    fused qkv views pass, a 66-float row pitch or a pointer one float past a
    boundary does not."""
    qkv = torch.zeros((2, 65, 3, 4, 64)).permute(2, 0, 3, 1, 4)
    tatt._check(qkv[0], qkv[1], qkv[2])
    tatt._check(*[torch.zeros((1, 2, 16, 68))[..., :64]] * 3)
    row_stride_66 = torch.zeros((1, 2, 16, 66))[..., :64]
    offset_pointer = torch.zeros(1 + 2 * 16 * 64)[1:].view(1, 2, 16, 64)
    for bad in (row_stride_66, offset_pointer):
        with pytest.raises(ValueError, match="aligned"):
            tatt._check(bad, bad, bad)


def test_attention_alignment_rule_of_the_bf16_route():
    """The bf16 kernel's cp.async copies and ldmatrix reads move 16 bytes,
    8 elements: 16-byte aligned pointers and (batch, head, row) strides that
    are multiples of 8 elements. The ViT's fused qkv views pass (row stride
    3·H·64); a 68-element row pitch, which float32 allows, does not, nor
    does a pointer one or four elements past a boundary."""
    qkv = torch.zeros((2, 65, 3, 4, 64), dtype=torch.bfloat16).permute(2, 0, 3, 1, 4)
    tatt._check(qkv[0], qkv[1], qkv[2])
    tatt._check(*[torch.zeros((1, 2, 16, 72), dtype=torch.bfloat16)[..., :64]] * 3)
    flat = torch.zeros(4 + 2 * 16 * 64, dtype=torch.bfloat16)
    for bad in (torch.zeros((1, 2, 16, pitch), dtype=torch.bfloat16)[..., :64] for pitch in (66, 68)):
        with pytest.raises(ValueError, match="multiples of 8 elements"):
            tatt._check(bad, bad, bad)
    for bad in (flat[1:1 + 2 * 16 * 64].view(1, 2, 16, 64), flat[4:].view(1, 2, 16, 64)):
        with pytest.raises(ValueError, match="aligned"):
            tatt._check(bad, bad, bad)


# The bf16 route (csrc/attention.cu): mma.sync.m16n8k16 fragments read with
# ldmatrix, P handed from S's C fragments to P·V's A fragments in registers,
# and the kernel's bf16 arithmetic.

_LDH = 72  # the kernel's row pitch of a bf16 K/V tile, in elements
_KEYS = 32  # keys a bf16 K/V tile (kKeys)


def _mma_m16n8k16(a, b, c):
    """One warp's mma.sync.m16n8k16 on per-lane fragments, as the PTX ISA
    gives them for .bf16: a (32, 8) holds a0..a7, a0a1 (g, 2t..), a2a3 (g+8,
    2t..), a4a5 (g, 2t+8..), a6a7 (g+8, 2t+8..); b (32, 4) holds b0..b3, b0b1
    (2t.., g), b2b3 (2t+8.., g); c (32, 4) as for m16n8k8."""
    am = torch.zeros((16, 16), dtype=a.dtype)
    for i, (dr, dk) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
        am[_G + dr, 2 * _T + dk], am[_G + dr, 2 * _T + dk + 1] = a[:, 2 * i], a[:, 2 * i + 1]
    bm = torch.zeros((16, 8), dtype=b.dtype)
    for i, dk in enumerate([0, 8]):
        bm[2 * _T + dk, _G], bm[2 * _T + dk + 1, _G] = b[:, 2 * i], b[:, 2 * i + 1]
    d = am @ bm
    return c + torch.stack([d[_G, 2 * _T], d[_G, 2 * _T + 1], d[_G + 8, 2 * _T], d[_G + 8, 2 * _T + 1]], 1)


def _ldmatrix_x4(tile, rows, cols, trans=False):
    """ldmatrix.sync.aligned.m8n8.x4[.trans].b16 from a (rows, cols) tile:
    lane 8i + r gives the address (rows[8i + r], cols[8i + r]) of row r of
    8×8 block i. Returns (32 lanes, 4 registers, 2 halves): register i of
    lane L holds row L >> 2 of block i, columns 2(L & 3) and +1; with .trans,
    column L >> 2 of rows 2(L & 3) and +1."""
    out = torch.zeros((32, 4, 2), dtype=tile.dtype)
    for i in range(4):
        r0, c0 = rows[8 * i:8 * i + 8], cols[8 * i:8 * i + 8]
        for e in range(2):
            if trans:
                out[:, i, e] = tile[r0[2 * _T + e], c0[2 * _T + e] + _G]
            else:
                out[:, i, e] = tile[r0[_G], c0[_G] + 2 * _T + e]
    return out


def _to_c_fragments(mat):
    """A 16×64 matrix as (8 n8 tiles, 32 lanes, 4) C fragments."""
    return torch.stack([torch.stack([mat[_G, 8 * j + 2 * _T], mat[_G, 8 * j + 2 * _T + 1], mat[_G + 8, 8 * j + 2 * _T],
                                     mat[_G + 8, 8 * j + 2 * _T + 1]], 1) for j in range(8)])


# the kernel's ldmatrix lane addresses (k_lane, v_lane in csrc/attention.cu) as (row, column) in a tile
_K_ROWS, _K_COLS = (_LANE & 7) + (_LANE >> 4) * 8, ((_LANE >> 3) & 1) * 8
_V_ROWS, _V_COLS = (_LANE & 7) + ((_LANE >> 3) & 1) * 8, (_LANE >> 4) * 8


def test_m16n8k16_fragments_ldmatrix_and_p_in_registers_give_one_warps_tile(rng):
    """One warp's 16 Q rows against 64 keys (two of the kernel's K/V tiles),
    with the bf16 kernel's index arithmetic: Q's A fragments read from memory, K's B fragments from
    ldmatrix.x4 without .trans (key tiles 2jj and 2jj+1 at k step c), S's C
    fragments of key tiles 2kk and 2kk+1 reused unchanged as P's A fragment
    of k step kk, and V's B fragments from ldmatrix.x4.trans (d tiles 2p and
    2p+1): Q·Kᵀ and P·V come out exact."""
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 64))) for n in (16, 64, 64))
    qa = torch.stack([torch.stack([q[_G + 8 * (r % 2), 16 * c + 8 * (r // 2) + 2 * _T + e]
                                   for r in range(4) for e in range(2)], 1) for c in range(4)])
    s = torch.zeros((8, 32, 4), dtype=torch.float64)
    for c in range(4):
        for jj in range(4):
            kf = _ldmatrix_x4(k, 16 * jj + _K_ROWS, 16 * c + _K_COLS)
            s[2 * jj] = _mma_m16n8k16(qa[c], kf[:, 0:2].reshape(32, 4), s[2 * jj])
            s[2 * jj + 1] = _mma_m16n8k16(qa[c], kf[:, 2:4].reshape(32, 4), s[2 * jj + 1])
    torch.testing.assert_close(_from_c_fragments(s), q @ k.T, rtol=1e-12, atol=1e-12)

    p = torch.softmax(_from_c_fragments(s), dim=-1)
    pc = _to_c_fragments(p)
    o = torch.zeros((8, 32, 4), dtype=torch.float64)
    for kk in range(4):
        pa = torch.cat([pc[2 * kk], pc[2 * kk + 1]], 1)  # c0..c3 of tile 2kk, then of 2kk+1: a0..a7
        for pp in range(4):
            vf = _ldmatrix_x4(v, 16 * kk + _V_ROWS, 16 * pp + _V_COLS, trans=True)
            o[2 * pp] = _mma_m16n8k16(pa, vf[:, 0:2].reshape(32, 4), o[2 * pp])
            o[2 * pp + 1] = _mma_m16n8k16(pa, vf[:, 2:4].reshape(32, 4), o[2 * pp + 1])
    torch.testing.assert_close(_from_c_fragments(o), p @ v, rtol=1e-12, atol=1e-12)

    # S's fragments in the order of P's A fragment with the halves of a register swapped break it
    swapped = torch.cat([pc[0][:, [1, 0, 3, 2]], pc[1][:, [1, 0, 3, 2]]], 1)
    vf = _ldmatrix_x4(v, _V_ROWS, _V_COLS, trans=True)
    good = _mma_m16n8k16(torch.cat([pc[0], pc[1]], 1), vf[:, 0:2].reshape(32, 4), torch.zeros((32, 4)))
    bad = _mma_m16n8k16(swapped, vf[:, 0:2].reshape(32, 4), torch.zeros((32, 4)))
    assert (good - bad).abs().max() > 1e-3


def test_bf16_tile_rows_read_without_bank_conflicts():
    """Each 8-lane phase of the kernel's ldmatrix reads eight 16-byte rows;
    at a 72-element (144-byte) pitch they fall in eight distinct groups of
    four banks, for K's and V's lane addresses at every offset in a tile."""
    for rows, cols in ((_K_ROWS, _K_COLS), (_V_ROWS, _V_COLS)):
        for r_off in range(0, _KEYS, 16):
            for c_off in range(0, 64, 16):
                addr = ((rows + r_off) * _LDH + cols + c_off) * 2
                assert (addr % 16 == 0).all()
                for phase in range(4):
                    groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                    assert len(set(groups.tolist())) == 8


def _attention_bf16_kernel_numerics(q, k, v, tile=_KEYS):
    """The bf16 kernel's arithmetic on (B, H, N, 64) bf16 tensors: f32
    logits, a base-2 online softmax over 32-key tiles, the unnormalised
    probabilities rounded to bf16 for an f32-accumulated product with V, the
    running sum from the unrounded values, a final divide and bf16 out."""
    scale_log2 = torch.tensor(64 ** -0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((*q.shape[:3], 1), -torch.inf)
    l = torch.zeros((*q.shape[:3], 1))
    acc = torch.zeros(q.shape)
    for k0 in range(0, q.shape[2], tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc * (1 / l)).to(torch.bfloat16)


@pytest.mark.parametrize("n", [97, 200])
def test_bf16_kernel_numerics_hold_xla_and_plain(rng, n):
    """Three tiles and one key, and six tiles and 8 keys: within the
    1e-2 bf16 tolerance of the JAX package's _attention_xla in bf16 and of
    attention_plain."""
    import jax.numpy as jnp

    q, k, v = _qkv(rng, (1, 2, n, 64))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _attention_bf16_kernel_numerics(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, n, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    xla = np.asarray(_attention_xla(jq, jk, jv, 64 ** -0.5).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), xla, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), tatt.attention_plain(tq, tk, tv).float(), atol=1e-2, rtol=1e-2)


# K4's f32 route (csrc/grouped_conv.cu): a 3xTF32 implicit GEMM on
# mma.sync.m16n8k8 with k = tap·(C/G) + ci tap-major, input channels staged
# in chunks of 8·wk (warp slice s takes channels 8s .. 8s+7 of each chunk),
# each chunk's products summed fresh, the slices' sums added at the end.


def _k4_grouped_inputs(rng, c, cg, h, w):
    x = rng.standard_normal((1, c, h, w)).astype(np.float32)
    k = (rng.standard_normal((c, cg, 3, 3)) / np.sqrt(9 * cg)).astype(np.float32)
    return x, k


def _k4_conv_tf32(x, weight, groups, wk=1, matmul=_matmul_3xtf32):
    """The f32 kernel's arithmetic on (B, C, H, W) and (C, C/G, 3, 3): A is
    the tap-major im2col (B, G, H·W, 9, C/G), B the weights as (G, 9, ci, co)."""
    b, c, h, w = x.shape
    cg = c // groups
    a = F.unfold(x, 3, padding=1).reshape(b, groups, cg, 9, h * w).permute(0, 1, 4, 3, 2)
    bm = weight.reshape(groups, cg, cg, 9).permute(0, 3, 2, 1)
    total = torch.zeros((b, groups, h * w, cg))
    for s in range(wk):
        run = torch.zeros_like(total)
        for ci0 in range(0, cg, 8 * wk):
            lo, hi = ci0 + 8 * s, min(ci0 + 8 * s + 8, cg)
            if lo < hi:  # this chunk's 9 taps × 8 channels, in fresh registers
                run = run + matmul(a[..., lo:hi].reshape(b, groups, h * w, -1),
                                   bm[:, :, lo:hi].reshape(groups, -1, cg))
        total = total + run
    return total.permute(0, 1, 3, 2).reshape(b, c, h, w)


@pytest.mark.parametrize("cg,groups,h,w,wk", [(8, 4, 9, 11, 1), (16, 2, 7, 8, 1), (32, 2, 6, 5, 4),
                                              (64, 2, 5, 7, 4), (64, 2, 6, 8, 2), (2, 4, 5, 7, 1)])
def test_k4_3xtf32_implicit_gemm_holds_pallas_and_plain(rng, cg, groups, h, w, wk):
    """C/G = 8, 16, 32, 64 and 2 at odd and even H, W, with the k split of
    the small maps: within 1e-4 of the Pallas kernel (interpret mode, f32 at
    precision "highest") and of grouped_conv3x3_plain."""
    import jax.numpy as jnp

    x, k = _k4_grouped_inputs(rng, cg * groups, cg, h, w)
    got = _k4_conv_tf32(torch.from_numpy(x), torch.from_numpy(k), groups, wk)
    plain = tgc.grouped_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(k), groups)
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
    pallas = grouped_conv3x3_pallas(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(k.transpose(2, 3, 1, 0)),
                                    groups, interpret=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(pallas), atol=1e-4, rtol=1e-4)


def test_k4_one_pass_tf32_misses_the_tolerance(rng):
    """Why the kernel takes three passes: at C/G = 64 (layer 4) one TF32
    pass lands some 1e-3 from the plain version, three within 1e-5."""
    x, k = map(torch.from_numpy, _k4_grouped_inputs(rng, 128, 64, 6, 8))
    plain = tgc.grouped_conv3x3_plain(x, k, 2)
    one = _k4_conv_tf32(x, k, 2, 4, _matmul_1xtf32)
    assert not torch.allclose(one, plain, atol=1e-4, rtol=1e-4)
    assert (one - plain).abs().max() > 3e-4
    assert (_k4_conv_tf32(x, k, 2, 4) - plain).abs().max() < 1e-5


def _pad_to(n, r, q):
    """csrc/grouped_conv.cu's pad_to: the least m ≥ n with m ≡ r (mod q)."""
    return n + (r - n % q) % q


# pick_gemm_tiling's choice at the MiDaS conv2 shapes, batch 1, 132 SMs
# (tests/test_torch_cuda.py holds the kernel's own to it): (C, H, W) →
# (nco, th, tw, wk, mt)
_K4_TILINGS = {(256, 48, 64): (8, 4, 64, 1, 4), (512, 24, 32): (16, 4, 32, 1, 2),
               (1024, 12, 16): (16, 3, 16, 4, 3), (2048, 6, 8): (8, 6, 8, 4, 3)}


def _k4_layout(th, tw, wk):
    """A buffer's pitches as the kernel sets them: input row pitch rw (the
    halo at column 3, the tile's columns from 4), plane pitch, weight row
    pitch pco (one output channel's ck·9 values, as stored), channels a
    chunk ck, and the weights' offset."""
    rw, ck = tw + 8, 8 * wk
    return rw, _pad_to((th + 2) * rw, 8, 16), 9 * ck + 4, ck, ck * _pad_to((th + 2) * rw, 8, 16)


def _k4_fragment_words(nco, th, tw, wk, mt_count, wm, ks, mt, tap):
    """The kernel's word addresses in a buffer for one k8 step (tap, slice
    ks) of m16 tile mt of warp wm: A's a0..a3 (32 lanes, 4) and, per n8 tile,
    B's b0, b1 (nco / 8, 32 lanes, 2); and the tile's pixel indices (32, 2)
    for fragment rows g and g + 8."""
    rw, plane, pco, ck, w_base = _k4_layout(th, tw, wk)
    p = (wm * mt_count + mt) * 16 + _G[:, None] + 8 * torch.arange(2)
    a_off = torch.where(p < th * tw, p // tw * rw + p % tw + 3, 0)  # once per lane, before the k loop
    toff = tap // 3 * rw + tap % 3
    xs = (8 * ks + _T[:, None]) * plane + a_off + toff
    a = torch.cat([xs, xs + 4 * plane], 1)  # (g, t) (g+8, t) (g, t+4) (g+8, t+4)
    ws = w_base + _G * pco + (8 * ks + _T) * 9 + tap
    b = torch.stack([torch.stack([ws + 8 * nt * pco, ws + 8 * nt * pco + 36], 1) for nt in range(nco // 8)])
    return a, b, p


def _k4_staged_buffer(x, weight, cg, nco, th, tw, wk, r0, c0, co0, ci0):
    """One chunk's buffer as the kernel's cp.async copies fill it: input
    planes [ci][th + 2][rw] with the tile from column 4 and a zero halo at
    columns 3 and tw + 4, then weights [co][ci·9 + tap]; zeros for channels
    past the group."""
    rw, plane, pco, ck, w_base = _k4_layout(th, tw, wk)
    buf = torch.zeros(w_base + nco * pco, dtype=x.dtype)
    xp = F.pad(x, (1, 1 + tw, 1, 1 + th))  # zeros around the image and past the last tile
    for ci in range(min(ck, cg - ci0)):
        tile = xp[ci0 + ci, r0:r0 + th + 2, c0:c0 + tw + 2]
        for rr in range(th + 2):
            buf[ci * plane + rr * rw + 3:ci * plane + rr * rw + tw + 5] = tile[rr]
        for co in range(min(nco, cg - co0)):
            buf[w_base + co * pco + ci * 9 + torch.arange(9)] = weight[co0 + co, ci0 + ci].reshape(-1)
    return buf


@pytest.mark.parametrize("nco,th,tw,wk,mt_count,h,w,cg", [
    (8, 6, 8, 4, 3, 6, 8, 64),     # layer 4: W = 8, so each m16 tile spans two image rows
    (16, 3, 16, 4, 3, 12, 16, 32),  # layer 3's tile, one of four row tiles
    (8, 2, 7, 1, 1, 5, 7, 5),      # ragged: 14 pixels a tile, C/G = 5
], ids=["layer4", "layer3", "ragged"])
def test_k4_lane_mapping_rebuilds_one_warps_tile(rng, nco, th, tw, wk, mt_count, h, w, cg):
    """Each warp's m16 × n8 tiles from the kernel's fragment offsets, through
    one warp's mma on per-lane fragments: every live pixel row and channel
    equals the convolution of that slice's 8 input channels, exactly."""
    x = torch.from_numpy(rng.standard_normal((cg, h, w)))
    weight = torch.from_numpy(rng.standard_normal((cg, cg, 3, 3)))
    r0, c0 = (h - 1) // th * th, 0  # the last row tile, which may reach past the image
    for ci0 in range(0, cg, 8 * wk):
        buf = _k4_staged_buffer(x, weight, cg, nco, th, tw, wk, r0, c0, 0, ci0)
        for ks in range(wk):
            lo, hi = ci0 + 8 * ks, min(ci0 + 8 * ks + 8, cg)
            if lo >= hi:
                continue
            ref = F.conv2d(x[None, lo:hi], weight[:nco, lo:hi], padding=1)[0]  # (co, H, W)
            for wm in range(4 // wk):
                for mt in range(mt_count):
                    c = torch.zeros((nco // 8, 32, 4), dtype=torch.float64)
                    for tap in range(9):
                        a, b, p = _k4_fragment_words(nco, th, tw, wk, mt_count, wm, ks, mt, tap)
                        for nt in range(nco // 8):
                            c[nt] = _mma_m16n8k8(buf[a], buf[b[nt]], c[nt])
                    for nt in range(nco // 8):
                        for hh in range(2):
                            pix = p[:, hh]
                            row, col = r0 + pix // tw, c0 + pix % tw
                            live = (pix < th * tw) & (row < h)
                            for e in range(2):
                                co = 8 * nt + 2 * _T + e
                                live_c = live & (co < cg)
                                want = ref[co[live_c], row[live_c], col[live_c]]
                                torch.testing.assert_close(c[nt][live_c, 2 * hh + e], want, rtol=1e-12, atol=1e-12)
    # the layer-4 tile's m16 tile 1 holds pixels 16..31: image rows 2 and 3
    assert torch.equal(_k4_fragment_words(8, 6, 8, 4, 3, 0, 0, 1, 0)[2][:, 0] // 8, torch.full((32,), 2))


@pytest.mark.parametrize("shape", list(_K4_TILINGS), ids=["layer1", "layer2", "layer3", "layer4"])
def test_k4_fragment_reads_without_bank_conflicts(shape):
    """Every shared-memory read of an A or B fragment, at the kernel's
    tiling of each MiDaS shape, touches 32 distinct banks. A: the plane
    pitch ≡ 8 (mod 16) words puts the four t values on four bank octets and
    the g values (neighbouring pixels) on consecutive banks. B: the weight
    row pitch ≡ 4 (mod 8) puts the eight g values (output channels) on the
    eight multiples of 4 (mod 32), and t (input channel, 9 words apart)
    adds 0, 1, 2, 3 (mod 4)."""
    nco, th, tw, wk, mt_count = _K4_TILINGS[shape]
    assert 4 * mt_count * 16 // wk >= th * tw > 4 * (mt_count - 1) * 16 // wk  # the tile fills the warps
    for ks in range(wk):
        for wm in range(4 // wk):
            for mt in range(mt_count):
                for tap in range(9):
                    a, b, _ = _k4_fragment_words(nco, th, tw, wk, mt_count, wm, ks, mt, tap)
                    for words in [*a.T, *b.reshape(-1, 32, 2).permute(0, 2, 1).reshape(-1, 32)]:
                        assert len(set((words % 32).tolist())) == 32
    # without the padding (pco = ck·9, a multiple of 8) channels g and g + 4 would share banks
    assert all(len({(g * 9 * ck) % 32 for g in range(8)}) < 8 for ck in (8, 16, 32))


def test_k4_breakdown_macros_are_in_the_source_and_keyed_apart():
    """tools/k4_breakdown.py builds the kernel with each of its macros: each
    is one the source tests, and each build gets a library of its own beside
    the port's, which takes no macro."""
    from depth_estimation_tpu_torch.ops.kernels import build

    src = (build.CSRC / "grouped_conv.cu").read_text()
    tool = (build.CSRC.parents[1] / "tools" / "k4_breakdown.py").read_text()
    macros = set(re.findall(r'"(K4_[A-Z_]+)"', tool))
    assert macros == {"K4_NO_STAGE", "K4_NO_MMA", "K4_LAUNCH_ONLY"}
    for macro in macros:
        assert re.search(rf"^#ifn?def {macro}\b", src, re.M), macro
    paths = {build.library_path("grouped_conv")} | {build.library_path("grouped_conv", (m,)) for m in macros}
    assert len(paths) == 1 + len(macros)


# K4's bf16 route (csrc/grouped_conv.cu): the f32 route's GEMM on
# mma.sync.m16n8k16 .bf16, one k16 step = two taps × the slice's 8 input
# channels (taps 2i, 2i + 1; the tenth tap's fragments are zero registers),
# bf16 values staged in bf16 pitches, each 32-bit fragment register two
# 16-bit shared reads, f32 sums rounded to bf16 once at the store.


def _k4_conv_bf16(x, weight, groups, wk=1):
    """The bf16 kernel's arithmetic on bf16 (B, C, H, W) and (C, C/G, 3, 3):
    A the tap-major im2col with a zero tenth tap, B the weights as (G, 10,
    ci, co); per slice s, each chunk's 8 channels of s in five k16 steps of
    f32 products of bf16 values (exact) summed in f32 across all chunks, the
    slices' sums added in order, one rounding to bf16."""
    b, c, h, w = x.shape
    cg = c // groups
    a = F.unfold(x.float(), 3, padding=1).reshape(b, groups, cg, 9, h * w).permute(0, 1, 4, 3, 2)
    a = F.pad(a, (0, 0, 0, 1))  # (B, G, P, 10 taps, ci)
    bm = F.pad(weight.float().reshape(groups, cg, cg, 9).permute(0, 3, 2, 1), (0, 0, 0, 0, 0, 1))  # (G, 10, ci, co)
    total = torch.zeros((b, groups, h * w, cg))
    for s in range(wk):
        run = torch.zeros_like(total)
        for ci0 in range(0, cg, 8 * wk):
            lo, hi = ci0 + 8 * s, min(ci0 + 8 * s + 8, cg)
            for step in range(5 if lo < hi else 0):
                taps = slice(2 * step, 2 * step + 2)
                a_step = a[..., taps, lo:hi].reshape(b, groups, h * w, -1)
                run = run + a_step @ bm[:, taps, lo:hi].reshape(groups, -1, cg)
        total = total + run
    return total.permute(0, 1, 3, 2).reshape(b, c, h, w).to(torch.bfloat16)


@pytest.mark.parametrize("cg,groups,h,w,wk", [(8, 4, 9, 11, 1), (16, 2, 7, 8, 1), (32, 2, 6, 5, 4),
                                              (64, 2, 5, 7, 4), (64, 2, 6, 8, 2), (2, 4, 5, 7, 1),
                                              (16, 2, 6, 8, 2)])
def test_k4_bf16_implicit_gemm_holds_pallas_and_plain(rng, cg, groups, h, w, wk):
    """C/G = 8, 16, 32, 64 and 2 at odd and even H, W, with wk = 1, 2, 4:
    the bf16 kernel's arithmetic within the bf16 tolerance 1e-2 of the
    Pallas kernel (interpret mode, bf16 at precision "default") and of
    grouped_conv3x3_plain, both in bf16."""
    import jax.numpy as jnp

    x, k = (torch.from_numpy(a).to(torch.bfloat16) for a in _k4_grouped_inputs(rng, cg * groups, cg, h, w))
    got = _k4_conv_bf16(x, k, groups, wk)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), tgc.grouped_conv3x3_plain(x, k, groups).float(), atol=1e-2, rtol=1e-2)
    jx = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
    jk = jnp.asarray(k.float().permute(2, 3, 1, 0).numpy(), jnp.bfloat16)
    pallas = np.asarray(grouped_conv3x3_pallas(jx, jk, groups, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), pallas, atol=1e-2, rtol=1e-2)


def _k4_bf16_layout(th, tw, wk):
    """The bf16 route's pitches in bf16 values, as pick_gemm_tiling sets
    them: input row pitch rw (the tile from element 8, halo pairs at 6 and
    tw + 8, a multiple of 8), plane pitch ≡ 8 (mod 32), weight row pitch pco
    ≡ 8 (mod 16), channels a chunk ck, and the weights' offset."""
    rw, ck = -(-(tw + 10) // 8) * 8, 8 * wk
    plane = _pad_to((th + 2) * rw, 8, 32)
    return rw, plane, _pad_to(9 * ck, 8, 16), ck, ck * plane


def _k4_bf16_stage(x, weight, cg, nco, th, tw, wk, r0, c0, co0, ci0, aligned):
    """One chunk's buffer as the bf16 kernel's stage_chunk fills it, copy by
    copy, NaN where no copy writes; x (C/G, H, W), weight (C/G, C/G, 3, 3) of
    one group. Aligned: a staged row in 16-byte copies of 8 values from
    element 8 and a 4-byte halo pair on either side, weight rows in 16-byte
    copies; otherwise one value a copy, columns -1 .. tw. Also returns the
    copies as (first element, values, source element or None)."""
    h, w = x.shape[-2:]
    rw, plane, pco, ck, w_base = _k4_bf16_layout(th, tw, wk)
    buf = torch.full((w_base + nco * pco,), float("nan"), dtype=x.dtype)
    xf, wf = x.reshape(-1), weight.reshape(cg, cg * 9)
    copies = []
    xv = 8 if aligned else 1
    for ci in range(ck):
        for rr in range(th + 2):
            for cc in range(2 + tw // xv):
                c, row = ci0 + ci, r0 - 1 + rr
                row_live = c < cg and 0 <= row < h
                if not aligned:
                    col, n = cc - 1, 1
                elif cc >= 2:
                    col, n = 8 * (cc - 2), 8
                else:
                    col, n = (-2 if cc == 0 else tw), 2
                live = row_live and 0 <= c0 + col < w
                dst, src = ci * plane + rr * rw + 8 + col, c * h * w + row * w + c0 + col
                buf[dst:dst + n] = xf[src:src + n] if live else 0
                copies.append((dst, n, src if live else None))
    wv = 8 if aligned else 1
    for co in range(nco):
        for j in range(9 * ck // wv):
            f0 = ci0 * 9 + wv * j
            valid = min(max(cg * 9 - f0, 0), wv) if co0 + co < cg else 0
            dst = w_base + co * pco + wv * j
            buf[dst:dst + wv] = 0
            if valid:
                buf[dst:dst + valid] = wf[co0 + co, f0:f0 + valid]
            copies.append((dst, wv, (co0 + co) * cg * 9 + f0 if valid else None))
    return buf, copies


def _k4_bf16_fragment_elems(nco, th, tw, wk, mt_count, wm, ks, mt, step):
    """The bf16 kernel's element addresses in a buffer for k16 step `step`
    (taps 2·step and 2·step + 1) of slice ks, m16 tile mt of warp wm: A's
    a0..a7 (32 lanes, 8), per n8 tile B's b0..b3 (nco / 8, 32, 4), -1 for
    the zero tap's registers (no read); and the tile's pixel indices (32, 2)."""
    rw, plane, pco, ck, w_base = _k4_bf16_layout(th, tw, wk)
    p = (wm * mt_count + mt) * 16 + _G[:, None] + 8 * torch.arange(2)
    a_off = torch.where(p < th * tw, p // tw * rw + p % tw + 7, 0)  # once per lane, before the k loop
    xs = (8 * ks + 2 * _T) * plane  # channel 2t of the slice; 2t + 1 is a plane on
    ws = w_base + _G * pco + (8 * ks + 2 * _T) * 9
    a, b = [], [[] for _ in range(nco // 8)]
    for tap in (2 * step, 2 * step + 1):
        off = tap // 3 * rw + tap % 3
        for hh in range(2):  # a0a1 / a4a5: pixel g; a2a3 / a6a7: pixel g + 8
            e = xs + a_off[:, hh] + off
            a += [e, e + plane] if tap < 9 else [torch.full((32,), -1)] * 2
        for nt in range(nco // 8):
            e = ws + 8 * nt * pco + tap
            b[nt] += [e, e + 9] if tap < 9 else [torch.full((32,), -1)] * 2
    return torch.stack(a, 1), torch.stack([torch.stack(r, 1) for r in b]), p


def _gather(buf, idx):
    return torch.where(idx >= 0, buf[idx.clamp(min=0)], torch.zeros((), dtype=buf.dtype))


@pytest.mark.parametrize("nco,th,tw,wk,mt_count,h,w,cg,aligned", [
    (8, 6, 8, 4, 3, 6, 8, 64, True),      # layer 4: W = 8, so each m16 tile spans two image rows
    (16, 3, 16, 4, 3, 12, 16, 32, True),  # layer 3's tile, one of four row tiles
    (8, 4, 64, 1, 4, 9, 64, 8, True),     # layer 1's tile, the last row tile reaching past the image
    (8, 2, 7, 1, 1, 5, 7, 5, False),      # ragged: 14 pixels a tile, C/G = 5, one value a copy
], ids=["layer4", "layer3", "layer1", "ragged"])
def test_k4_bf16_lane_mapping_rebuilds_one_warps_tile(rng, nco, th, tw, wk, mt_count, h, w, cg, aligned):
    """Each warp's m16 × n8 tiles from the bf16 kernel's fragment addresses
    (two 16-bit reads packed a register, the zero tap as zero registers) on
    the buffer its copies stage, through one warp's m16n8k16 on per-lane
    fragments: every live pixel row and channel equals the convolution of
    that slice's 8 input channels, exactly; nothing unstaged is read."""
    x = torch.from_numpy(rng.standard_normal((cg, h, w)))
    weight = torch.from_numpy(rng.standard_normal((cg, cg, 3, 3)))
    r0, c0 = (h - 1) // th * th, 0  # the last row tile, which may reach past the image
    for ci0 in range(0, cg, 8 * wk):
        buf, _ = _k4_bf16_stage(x, weight, cg, nco, th, tw, wk, r0, c0, 0, ci0, aligned)
        for ks in range(wk):
            lo, hi = ci0 + 8 * ks, min(ci0 + 8 * ks + 8, cg)
            if lo >= hi:
                continue
            ref = F.conv2d(x[None, lo:hi], weight[:nco, lo:hi], padding=1)[0]  # (co, H, W)
            for wm in range(4 // wk):
                for mt in range(mt_count):
                    c = torch.zeros((nco // 8, 32, 4), dtype=torch.float64)
                    for step in range(5):
                        a, b, p = _k4_bf16_fragment_elems(nco, th, tw, wk, mt_count, wm, ks, mt, step)
                        assert not _gather(buf, b).isnan().any()
                        for nt in range(nco // 8):
                            c[nt] = _mma_m16n8k16(_gather(buf, a), _gather(buf, b[nt]), c[nt])
                    for nt in range(nco // 8):
                        for hh in range(2):
                            pix = p[:, hh]
                            row, col = r0 + pix // tw, c0 + pix % tw
                            live = (pix < th * tw) & (row < h)
                            for e in range(2):
                                co = 8 * nt + 2 * _T + e
                                live_c = live & (co < cg)
                                want = ref[co[live_c], row[live_c], col[live_c]]
                                torch.testing.assert_close(c[nt][live_c, 2 * hh + e], want, rtol=1e-12, atol=1e-12)
    # the layer-4 tile's m16 tile 1 holds pixels 16..31: image rows 2 and 3
    assert torch.equal(_k4_bf16_fragment_elems(8, 6, 8, 4, 3, 0, 0, 1, 0)[2][:, 0] // 8, torch.full((32,), 2))


@pytest.mark.parametrize("shape", list(_K4_TILINGS), ids=["layer1", "layer2", "layer3", "layer4"])
def test_k4_bf16_fragment_reads_without_bank_conflicts(shape):
    """Every 16-bit shared read of an A or B fragment half, at the kernel's
    tiling of each MiDaS shape, touches each bank in at most one word (lanes
    that read the two halves of one word share it): the plane pitch ≡ 8
    (mod 32) values puts the planes of channels 2t 8 words apart for t =
    0..3, with the at most 5 words of 8 neighbouring pixels between them;
    the weight row pitch ≡ 8 (mod 16) values puts output channels g on the
    multiples of 4 words and t (18 values = 9 words on) on the residues mod 4."""
    nco, th, tw, wk, mt_count = _K4_TILINGS[shape]

    def conflict_free(elems):
        words = (elems // 2).tolist()
        banks = {}
        for word in words:
            banks.setdefault(word % 32, set()).add(word)
        return all(len(ws) == 1 for ws in banks.values())

    for ks in range(wk):
        for wm in range(4 // wk):
            for mt in range(mt_count):
                for step in range(5):
                    a, b, _ = _k4_bf16_fragment_elems(nco, th, tw, wk, mt_count, wm, ks, mt, step)
                    for elems in [*a.T, *b.reshape(-1, 32, 4).permute(0, 2, 1).reshape(-1, 32)]:
                        assert (elems < 0).all() or conflict_free(elems)
    # without the padding a plane of 480 values (layer 1) puts the four t on one bank octet,
    # and weight rows of 144 values (wk = 2) output channels g and g + 4 on one bank
    assert not conflict_free(2 * _T * 480 + _G)
    assert not conflict_free(_G * 144 + 18 * _T)


@pytest.mark.parametrize("shape", list(_K4_TILINGS), ids=["layer1", "layer2", "layer3", "layer4"])
def test_k4_bf16_halo_pairs_land_the_staged_row(rng, shape):
    """The aligned staging at each MiDaS tiling, first and last row tile,
    every chunk, and a second column tile of an input twice as wide (whose
    leading halo pair lies in the image): the 16-byte copies of 8 values and
    the 4-byte halo pairs are aligned at both ends (16 and 4 bytes in shared
    memory and in a 16-byte aligned tensor), write disjoint values, and land
    the padded input's columns c0 − 1 .. c0 + tw at elements 7 .. tw + 8 of
    each staged row, where the fragment offsets read them (zeros outside the
    image), and each weight (co, ci, tap) at co·pco + ci·9 + tap; the
    one-value staging of unaligned rows lands the same values there."""
    c, h, w = shape
    nco, th, tw, wk, _ = _K4_TILINGS[shape]
    cg = c // 32
    weight = torch.from_numpy(rng.standard_normal((cg, cg, 3, 3)))
    for width, c0 in ((w, 0), (2 * w, w)):
        x = torch.from_numpy(rng.standard_normal((cg, h, width)))
        xp = F.pad(x, (1, 1 + tw, 1, 1 + th))
        _k4_bf16_check_staging(x, xp, weight, cg, nco, th, tw, wk, c0, h)


def _k4_bf16_check_staging(x, xp, weight, cg, nco, th, tw, wk, c0, h):
    rw, plane, pco, ck, w_base = _k4_bf16_layout(th, tw, wk)
    for r0 in sorted({0, (h - 1) // th * th}):
        for ci0 in range(0, cg, ck):
            buf, copies = _k4_bf16_stage(x, weight, cg, nco, th, tw, wk, r0, c0, 0, ci0, True)
            written = torch.zeros(buf.shape, dtype=torch.int64)
            for dst, n, src in copies:
                assert n in (2, 8) and (2 * dst) % (2 * n) == 0 and (src is None or src % n == 0)
                written[dst:dst + n] += 1
            assert written.max() == 1
            plain, _ = _k4_bf16_stage(x, weight, cg, nco, th, tw, wk, r0, c0, 0, ci0, False)
            for ci in range(ck):
                for rr in range(th + 2):
                    row = buf[ci * plane + rr * rw + 7:ci * plane + rr * rw + tw + 9]
                    want = (xp[ci0 + ci, r0 + rr, c0:c0 + tw + 2] if ci0 + ci < cg
                            else torch.zeros(tw + 2, dtype=x.dtype))
                    torch.testing.assert_close(row, want, rtol=0, atol=0)
                    torch.testing.assert_close(plain[ci * plane + rr * rw + 7:ci * plane + rr * rw + tw + 9], want,
                                               rtol=0, atol=0)
            staged_w = buf[w_base:].reshape(nco, pco)[:, :9 * ck].reshape(nco, ck, 9)
            torch.testing.assert_close(staged_w, weight[:nco, ci0:ci0 + ck].reshape(nco, ck, 9), rtol=0, atol=0)


# -- the linear layers' f32 GEMM (csrc/linear.cu): the operator's CPU, fake
# and autograd implementations, the tiling, the weight cache and the 3xTF32
# arithmetic.


@pytest.mark.parametrize("gelu", [False, True], ids=["linear", "linear_gelu"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_linear_cpu_implementation_is_nn_linear(rng, gelu, bias):
    """On CPU tensors the operator is ``nn.Linear`` (+ ``nn.GELU()``) bit for
    bit, so the CPU programs are unchanged."""
    layer = torch.nn.Linear(64, 96, bias=bias)
    x = torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(np.float32))
    want = layer(x)
    if gelu:
        want = torch.nn.GELU()(want)
    got = tlin.linear(x, layer.weight, layer.bias, gelu)
    assert torch.equal(got, want)
    assert torch.equal(torch.ops.depth_tpu_torch.linear(x, layer.weight, layer.bias, gelu), want)


def test_linear_fake_implementation_gives_the_output_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x, w = torch.empty((3, 5, 64)), torch.empty((96, 64))
        out = torch.ops.depth_tpu_torch.linear(x, w, None, True)
    assert out.shape == (3, 5, 96) and out.dtype == torch.float32


def test_linear_refuses_other_devices():
    with pytest.raises(ValueError, match="no linear kernel"):
        tlin.linear(torch.empty((2, 64), device="meta"), torch.empty((8, 64), device="meta"))


def test_vit_block_exports_through_the_linear_operator(rng):
    """``torch.export`` of a ViT block (two heads of 64): its four linear
    layers are four operator nodes (fc1's with GELU), beside one K1 node, and
    the exported program holds the live block bit for bit."""
    from depth_estimation_tpu_torch.models.vit import Block

    torch.manual_seed(0)
    blk = Block(128, 2).eval()
    x = torch.from_numpy(rng.standard_normal((1, 33, 128)).astype(np.float32))
    prog = torch.export.export(blk, (x,))
    calls = [n for n in prog.graph.nodes if n.op == "call_function"]
    lin = [n for n in calls if n.target == torch.ops.depth_tpu_torch.linear.default]
    assert len(lin) == 4 and [n.args[3] for n in lin] == [False, False, True, False]
    assert sum(n.target == torch.ops.depth_tpu_torch.attention.default for n in calls) == 1
    with torch.no_grad():
        assert torch.equal(prog.module()(x), blk(x))


@pytest.mark.parametrize("gelu", [False, True], ids=["linear", "linear_gelu"])
def test_linear_gradients_are_f_linears(rng, gelu):
    """The registered backward (plain products, the GELU's derivative at the
    recomputed pre-activation) against autograd through ``F.linear`` (+
    ``F.gelu``); without a bias, db is None."""
    x = torch.from_numpy(rng.standard_normal((3, 17, 64)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal(48).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((3, 17, 48)).astype(np.float32))
    for bias in (b, None):
        leaves = [t for t in (x, w, bias) if t is not None]
        got = torch.autograd.grad(tlin.linear(x, w, bias, gelu), leaves, dy)
        ref = F.linear(x, w, bias)
        want = torch.autograd.grad(F.gelu(ref) if gelu else ref, leaves, dy)
        for g, wnt in zip(got, want):
            torch.testing.assert_close(g, wnt, rtol=1e-5, atol=1e-5)


def test_dpt_state_dict_is_the_hubs():
    """The modules keep ``nn.Linear`` (and the readout's ``Sequential(Linear,
    GELU)``): after a forward through the operator the state dict has the same
    keys and values, no remainder or descriptor among them."""
    from depth_estimation_tpu_torch.models.dpt import DPT
    from tests.test_torch_dpt import TINY

    torch.manual_seed(0)
    model = DPT(TINY).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model(torch.zeros((1, 3, 64, 96)))
    after = model.state_dict()
    assert list(after) == list(before) and all(torch.equal(after[k], before[k]) for k in before)
    for key in ("pretrained.model.blocks.0.attn.qkv.weight", "pretrained.model.blocks.0.mlp.fc1.bias",
                "pretrained.model.blocks.3.mlp.fc2.weight", "pretrained.act_postprocess1.0.project.0.weight"):
        assert key in after
    assert isinstance(model.pretrained.act_postprocess1._modules["0"].project[1], torch.nn.GELU)


@pytest.mark.parametrize("m,n,want", [(769, 1024, 64), (769, 3072, 64), (769, 4096, 128), (3076, 1024, 128),
                                      (3076, 4096, 128), (6152, 3072, 128), (6152, 768, 128), (1, 1024, 64),
                                      (193, 3072, 64)])
def test_linear_tiling_at_the_cells_shapes(m, n, want):
    """The tile width that fills the 132 SMs best; at one frame and N = 1024 the
    64-wide tiles (112 of them) over the 128-wide (56)."""
    assert tlin.tiling(m, n, 132) == want


def test_linear_tiling_costs_rounds_of_the_grid():
    """Each choice is the cheaper by its own cost model, and a shape whose
    tiles fit one round at either width takes the narrower."""
    for m in (1, 193, 385, 769, 3076, 6152):
        for n in (256, 576, 768, 1024, 2304, 3072, 4096):
            m_tiles = -(-m // tlin.BLOCK_M)
            cost = {bn: -(-m_tiles * -(-n // bn) // 132) * (bn + tlin.TILE_OVERHEAD) for bn in tlin.BLOCK_NS}
            assert cost[tlin.tiling(m, n, 132)] == min(cost.values())


def test_linear_tiling_constants_match_the_source():
    src = (build.CSRC / "linear.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kBlockM"]), int(consts["kBlockK"])) == (tlin.BLOCK_M, tlin.BLOCK_K)
    assert "if (block_n == 128)" in src and "if (block_n == 64)" in src and tlin.BLOCK_NS == (128, 64)
    assert "linear" in build.SOURCES and "linear_gemm_f32x3_kernel" in src  # `gemm` classes it as a dense layer


def test_linear_weight_entry_follows_the_weight():
    """The remainder is w − trunc(w), exact and below 2^-10 of w; a weight's
    entry (its checks, remainder and maps) is made again after an in-place
    update and dropped with the weight's storage. A CPU weight's entry says
    the kernel does not take it and holds no remainder."""
    import gc

    w = torch.randn((64, 96))
    lo = tlin.weight_lo(w)
    torch.testing.assert_close(lo + tf32_trunc(w), w, rtol=0, atol=0)
    assert not (tf32_trunc(w).view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= w.abs() * 2.0 ** -10).all()
    entry = tlin._weight_entry(w)
    assert tlin._weight_entry(w) is entry and (entry.n, entry.k) == (64, 96)
    assert not entry.takes and entry.lo is None and entry.dev == -1
    w.mul_(2)
    assert tlin._weight_entry(w) is not entry
    key = id(w.untyped_storage())
    assert key in tlin._WEIGHTS
    del w, entry
    gc.collect()
    assert key not in tlin._WEIGHTS


def test_linear_weight_entry_is_the_storages():
    """A module's weight and the detached tensors of each fresh
    ``state_dict()`` (the exported programs' ``fn(est.params, frame)``) share
    one entry; another view of the storage has its own; an in-place update
    through either tensor is seen through both; ``param.data = …`` (a dtype
    round trip) leaves the old storage and its entry behind."""
    layer = torch.nn.Linear(96, 64)
    entry = tlin._weight_entry(layer.weight)
    for _ in range(2):
        assert tlin._weight_entry(layer.state_dict()["weight"]) is entry
    half = tlin._weight_entry(layer.weight[:32])
    assert half is not entry and (half.n, half.k) == (32, 96)
    assert tlin._weight_entry(layer.weight[:32]) is half
    with torch.no_grad():
        layer.state_dict()["weight"].mul_(2)
    again = tlin._weight_entry(layer.weight)
    assert again is not entry and tlin._weight_entry(layer.state_dict()["weight"]) is again
    layer.weight.data = layer.weight.data.half().float()
    assert tlin._weight_entry(layer.weight) is not again


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_vit_dense_picks_the_operator_by_dtype(monkeypatch, dtype):
    """``vit.dense`` sends float32 to the f32 GEMM kernel's wrapper and other
    dtypes (bf16 runs on cuBLAS's tensor-core route) to ``F.linear`` + GELU,
    with or without the bias; both give ``nn.Linear``'s result."""
    from depth_estimation_tpu_torch.models import vit

    calls = []
    monkeypatch.setattr(vit, "linear", lambda *a: calls.append(a) or tlin.linear(*a))
    layer = torch.nn.Linear(64, 96).to(dtype)
    x = torch.randn((2, 7, 64), dtype=dtype)
    for bias, gelu in ((True, False), (True, True), (False, False)):
        want = F.linear(x, layer.weight, layer.bias if bias else None)
        got = vit.dense(layer, x, bias=bias, gelu=gelu)
        assert got.dtype == dtype and torch.equal(got, F.gelu(want) if gelu else want)
    assert len(calls) == (3 if dtype is torch.float32 else 0)


def _linear_3xtf32(x, w, slice_k=32):
    """The kernel's arithmetic: x split by rounding, w by truncation (w_lo the
    cached remainder), lo·hi + hi·lo + hi·hi a 32-deep slice at a time, each
    slice's sum added to the f32 accumulator."""
    (x_hi, x_lo), (w_hi, w_lo) = _split_a(x), _split_b(w)
    acc = torch.zeros((x.shape[0], w.shape[0]))
    for k0 in range(0, x.shape[1], slice_k):
        sl = slice(k0, k0 + slice_k)
        acc = acc + (x_lo[:, sl] @ w_hi[:, sl].T + x_hi[:, sl] @ w_lo[:, sl].T + x_hi[:, sl] @ w_hi[:, sl].T)
    return acc


def test_3xtf32_linear_holds_float64_as_f32_does(rng):
    """At fc2's depth (K = 4096) with ×30 inputs: the split products land
    within twice plain f32's distance from float64; one TF32 pass does not."""
    x = torch.from_numpy(30 * rng.standard_normal((64, 4096)).astype(np.float32))
    w = torch.from_numpy((30 / 64) * rng.standard_normal((48, 4096)).astype(np.float32))
    exact = x.double() @ w.double().T
    scale = exact.abs().max()

    def err(y):
        return ((y.double() - exact).abs().max() / scale).item()

    f32 = err(x @ w.T)
    assert err(_linear_3xtf32(x, w)) <= max(2 * f32, 1e-6)
    assert err(tf32_round(x) @ tf32_round(w).T) > 30 * f32
