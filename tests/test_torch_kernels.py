"""The port's kernels' plain PyTorch versions against the JAX package's
kernels (Pallas in interpret mode) and their XLA forms, on the CPU. The CUDA
kernels themselves are tested against these plain versions in
tests/test_torch_cuda.py, on a GPU."""

import numpy as np
import pytest
import torch

from depth_estimation_tpu.config import DPT_PREPROCESS, SMALL_PREPROCESS
from depth_estimation_tpu.ops.pallas.attention import _attention_xla
from depth_estimation_tpu.ops.pallas.attention import multi_head_attention as jax_mha
from depth_estimation_tpu.ops.pallas.resize import pallas_preprocess, pallas_resize2d
from depth_estimation_tpu.ops.preprocess import compute_resize_shape
from depth_estimation_tpu_torch.ops.kernels import attention as tatt
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
