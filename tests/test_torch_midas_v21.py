"""The port's MiDaS v2.1 and its grouped-conv kernel K4 against the JAX
package on the same weights and inputs (tiny config, CPU; the JAX Pallas
kernel runs in interpret mode, as its own tests run it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depth_estimation_tpu.models.midas_v21 import MIDAS_V21 as JAX_MIDAS_V21
from depth_estimation_tpu.models.midas_v21 import MidasV21 as JaxMidasV21
from depth_estimation_tpu.models.midas_v21 import MidasV21Config as JaxMidasV21Config
from depth_estimation_tpu.ops.pallas.grouped_conv import grouped_conv3x3_pallas
from depth_estimation_tpu.utils.convert import convert_midas_v21, midas_v21_expected_keys
from depth_estimation_tpu_torch.models.layers import FrozenBatchNorm2d
from depth_estimation_tpu_torch.models.midas_v21 import MIDAS_V21, MidasV21, MidasV21Config
from depth_estimation_tpu_torch.ops.kernels import grouped_conv as tgc
from depth_estimation_tpu_torch.utils.convert import params_from_jax_midas_v21
from tests.oracles import midas_v21_torch as oracle

# the JAX package's own tiny config (tests/test_midas_v21.py): C/G = 2, 4, 8, 16
TINY_FIELDS = dict(depths=(1, 1, 1, 1), planes=(8, 16, 32, 64), stem_features=8, groups=4,
                   width_per_group=16, features=16, head_features=8, head_mid=8)
TINY, JAX_TINY = MidasV21Config(**TINY_FIELDS), JaxMidasV21Config(**TINY_FIELDS)


@pytest.fixture(scope="module")
def hub_sd():
    return {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY, seed=7).items()}


@pytest.fixture(scope="module")
def jax_params(hub_sd):
    return convert_midas_v21(hub_sd, JAX_TINY)


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = MidasV21(TINY)
    model.load_state_dict(params_from_jax_midas_v21(jax_params, TINY))
    return model.eval()


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


# -- K4: grouped_conv3x3 -------------------------------------------------------

@pytest.mark.parametrize(
    "b,h,w,c,g,bc,vb",
    [  # the shapes of tests/test_grouped_conv_pallas.py, with its blockings on the JAX side
        (1, 6, 6, 16, 4, 8, 1 << 20),
        (2, 5, 7, 16, 4, 16, 1 << 20),
        (1, 8, 8, 32, 8, 128, 1 << 20),
        (1, 4, 4, 8, 8, 4, 1 << 20),
        (1, 8, 6, 16, 4, 16, 400),
        (2, 6, 6, 16, 4, 8, 300),
    ],
)
def test_grouped_conv_plain_matches_pallas(rng, b, h, w, c, g, bc, vb):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = rng.standard_normal((3, 3, c // g, c)).astype(np.float32)
    want = np.asarray(grouped_conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), g, block_channels=bc,
                                             interpret=True, vmem_block_bytes=vb))
    weight = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))  # (C, C/G, 3, 3)
    got = tgc.grouped_conv3x3_plain(_nchw(x), weight, g).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_grouped_conv_plain_zero_padding_edges(rng):
    """Border outputs see zeros, as a VALID conv of the explicitly padded input."""
    x = rng.standard_normal((1, 8, 6, 6)).astype(np.float32)
    k = rng.standard_normal((8, 2, 3, 3)).astype(np.float32)
    got = tgc.grouped_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(k), 4)
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = jax.lax.conv_general_dilated(xp, k, (1, 1), [(0, 0), (0, 0)],
                                        dimension_numbers=("NCHW", "OIHW", "NCHW"), feature_group_count=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_grouped_conv_plain_bf16_rounds_once(rng):
    x = torch.from_numpy(rng.standard_normal((1, 16, 5, 7)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((16, 4, 3, 3)).astype(np.float32)).bfloat16()
    got = tgc.grouped_conv3x3_plain(x, k, 4)
    assert got.dtype == torch.bfloat16
    want = F.conv2d(x.float(), k.float(), padding=1, groups=4).bfloat16()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_grouped_conv_wrapper_takes_plain_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((2, 16, 5, 7)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((16, 4, 3, 3)).astype(np.float32))
    before = tgc.grouped_conv3x3.launches
    got = tgc.grouped_conv3x3(x, k, 4)
    assert tgc.grouped_conv3x3.launches == before
    assert torch.equal(got, tgc.grouped_conv3x3_plain(x, k, 4))


def test_grouped_conv_wrapper_refuses(rng):
    x = torch.zeros((1, 16, 4, 4))
    with pytest.raises(ValueError, match="no grouped conv kernel"):
        tgc.grouped_conv3x3(x.to("meta"), torch.zeros((16, 4, 3, 3), device="meta"), 4)
    with pytest.raises(ValueError, match="not divisible"):
        tgc.grouped_conv3x3(x, torch.zeros((16, 4, 3, 3)), 3)
    with pytest.raises(ValueError, match="weight shape"):
        tgc.grouped_conv3x3(x, torch.zeros((16, 8, 3, 3)), 4)
    with pytest.raises(ValueError, match="weight shape"):
        tgc.grouped_conv3x3(x, torch.zeros((16, 4, 1, 1)), 4)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        tgc.grouped_conv3x3(x[0], torch.zeros((16, 4, 3, 3)), 4)


# -- the model -----------------------------------------------------------------

def test_frozen_batch_norm_matches_formula(rng):
    bn = FrozenBatchNorm2d(3)
    assert [n for n, _ in bn.named_buffers()] == ["weight", "bias", "running_mean", "running_var"]
    assert not list(bn.parameters())
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 5)).astype(np.float32))
    assert torch.allclose(bn(x), x, atol=1e-5 * 4)  # identity at init, up to rsqrt(1 + eps)
    for name in ("weight", "bias", "running_mean", "running_var"):
        getattr(bn, name).copy_(torch.from_numpy(rng.random(3).astype(np.float32) + 0.5))
    # the JAX FrozenBatchNorm's formula (models/layers.py)
    inv = bn.weight.numpy() / np.sqrt(bn.running_var.numpy() + 1e-5)
    want = x.numpy() * inv[:, None, None] + (bn.bias.numpy() - bn.running_mean.numpy() * inv)[:, None, None]
    np.testing.assert_allclose(bn(x).numpy(), want, atol=1e-6, rtol=1e-6)


def test_params_from_jax_inverts_convert_midas_v21(hub_sd, jax_params):
    sd = params_from_jax_midas_v21(jax_params, TINY)
    assert sorted(sd) == sorted(hub_sd)
    for k, v in hub_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_state_dict_keys_are_hub_keys(hub_sd):
    shapes = {k: tuple(v.shape) for k, v in MidasV21(TINY).state_dict().items()}
    assert sorted(shapes) == sorted(midas_v21_expected_keys(JAX_TINY))
    assert shapes == {k: v.shape for k, v in hub_sd.items()}


def test_config_matches_jax():
    fields = {f.name for f in dataclasses.fields(MidasV21Config)}
    assert dataclasses.asdict(MIDAS_V21) == {k: v for k, v in dataclasses.asdict(JAX_MIDAS_V21).items()
                                             if k in fields}
    assert fields == {f.name for f in dataclasses.fields(JaxMidasV21Config)} - {"conv2_impl"}
    assert [MIDAS_V21.width(p) for p in MIDAS_V21.planes] == [256, 512, 1024, 2048]


@pytest.mark.parametrize("conv2_impl", [None, ("pallas",) * 4], ids=["default", "pallas"])
@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_forward_matches_jax(rng, jax_params, port_model, hw, conv2_impl):
    cfg = JAX_TINY if conv2_impl is None else dataclasses.replace(JAX_TINY, conv2_impl=conv2_impl)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JaxMidasV21(cfg).apply)({"params": jax_params}, x))
    with torch.inference_mode():
        got = port_model(_nchw(x)).numpy()
    assert got.shape == ref.shape == (2, *hw)
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(got / scale, ref / scale, atol=5e-5)


def test_bfloat16_close_to_f32(rng, port_model):
    """The JAX package's own bf16 bound (tests/test_midas_v21.py): 0.1 max-scaled."""
    x = _nchw(rng.standard_normal((1, 64, 64, 3)).astype(np.float32))
    m16 = MidasV21(TINY)
    m16.load_state_dict(port_model.state_dict())
    m16 = m16.to(torch.bfloat16).eval()
    with torch.inference_mode():
        d32 = port_model(x).numpy()
        d16 = m16(x.bfloat16()).float().numpy()
    scale = np.abs(d32).max() + 1e-8
    np.testing.assert_allclose(d16 / scale, d32 / scale, atol=0.1)


def test_stride1_conv2s_go_through_the_wrapper(monkeypatch, rng):
    """Every stride-1 conv2 calls grouped_conv3x3 once; the strided ones
    (block 0 of layers 2-4) do not."""
    from depth_estimation_tpu_torch.models import midas_v21 as tm

    calls = []

    def spy(x, w, g):
        calls.append(tuple(x.shape))
        return tgc.grouped_conv3x3(x, w, g)

    monkeypatch.setattr(tm, "grouped_conv3x3", spy)
    model = MidasV21(dataclasses.replace(TINY, depths=(2, 1, 3, 2))).eval()
    with torch.inference_mode():
        model(_nchw(rng.standard_normal((1, 64, 64, 3)).astype(np.float32)))
    assert calls == [(1, 8, 16, 16)] * 2 + [(1, 32, 4, 4)] * 2 + [(1, 64, 2, 2)]


def test_registry_entry():
    """'MiDaS' resolves like the reference's non-DPT branch: small_transform
    preprocess (depth_midas.py:13-16) and the full v2.1 Large network."""
    from depth_estimation_tpu_torch.config import SMALL_PREPROCESS
    from depth_estimation_tpu_torch.registry import get_entry

    entry = get_entry("MiDaS")
    assert entry.preprocess == SMALL_PREPROCESS
    with torch.device("meta"):  # shapes only: nothing full-size is allocated
        model = entry.make_model()
    assert isinstance(model, MidasV21)
    assert model.cfg.depths == (3, 4, 23, 3) and model.cfg.features == 256
    assert sorted(model.state_dict()) == sorted(midas_v21_expected_keys())
