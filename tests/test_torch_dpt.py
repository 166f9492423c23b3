"""The port's DPT against the JAX DPT on the same weights (tiny configs, CPU):
DPT-Large's layout, and the hybrid's (ResNetV2-50 stem at full width, a tiny
ViT) with its stem alone."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.models.dpt import DPT_HYBRID as JAX_DPT_HYBRID
from depth_estimation_tpu.models.dpt import DPT_LARGE as JAX_DPT_LARGE
from depth_estimation_tpu.models.dpt import DPTConfig as JaxDPTConfig
from depth_estimation_tpu.models.resnetv2 import ResNetV2Stem as JaxResNetV2Stem
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch.models.dpt import DPT, DPT_HYBRID, DPT_LARGE, DPTConfig
from depth_estimation_tpu_torch.models.resnetv2 import ResNetV2Stem, standardize
from depth_estimation_tpu_torch.utils.convert import params_from_jax
from tests.oracles import dpt_torch as oracle

TINY_FIELDS = dict(embed_dim=64, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
                   reassemble_channels=(16, 32, 64, 64), features=32, img_size=64)
TINY, JAX_TINY = DPTConfig(**TINY_FIELDS), JaxDPTConfig(**TINY_FIELDS)
# the JAX package's own tiny hybrid (tests/test_dpt.py): levels 0 and 1 are the stem's 256/512-channel maps
TINY_HYBRID_FIELDS = dict(TINY_FIELDS, reassemble_channels=(256, 512, 64, 64), hybrid=True)
TINY_HYBRID, JAX_TINY_HYBRID = DPTConfig(**TINY_HYBRID_FIELDS), JaxDPTConfig(**TINY_HYBRID_FIELDS)


@pytest.fixture(scope="module")
def hub_sd():
    return {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY, seed=3).items()}


@pytest.fixture(scope="module")
def jax_params(hub_sd):
    return convert_dpt(hub_sd, JAX_TINY)


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = DPT(TINY)
    model.load_state_dict(params_from_jax(jax_params, TINY))
    return model.eval()


def test_params_from_jax_inverts_convert_dpt(hub_sd, jax_params):
    sd = params_from_jax(jax_params, TINY)
    assert sorted(sd) == sorted(hub_sd)
    for k, v in hub_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_state_dict_keys_are_hub_keys(hub_sd):
    shapes = {k: tuple(v.shape) for k, v in DPT(TINY).state_dict().items()}
    assert shapes == {k: v.shape for k, v in hub_sd.items()}


def _assert_config_matches_jax(port, jax_cfg):
    fields = {f.name for f in dataclasses.fields(DPTConfig)}
    assert dataclasses.asdict(port) == {k: v for k, v in dataclasses.asdict(jax_cfg).items() if k in fields}


def test_dpt_large_config_matches_jax():
    _assert_config_matches_jax(DPT_LARGE, JAX_DPT_LARGE)


def test_dpt_hybrid_config_matches_jax():
    _assert_config_matches_jax(DPT_HYBRID, JAX_DPT_HYBRID)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)], ids=["native_grid", "pos_embed_resized"])
def test_forward_matches_jax(rng, jax_params, port_model, hw):
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JaxDPT(JAX_TINY).apply)({"params": jax_params}, x))
    with torch.inference_mode():
        got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.shape == ref.shape == (1, *hw)
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(got / scale, ref / scale, atol=5e-5)



# -- DPT-Hybrid -----------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid_hub_sd():
    return {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY_HYBRID, seed=5).items()}


@pytest.fixture(scope="module")
def hybrid_jax_params(hybrid_hub_sd):
    return convert_dpt(hybrid_hub_sd, JAX_TINY_HYBRID)


@pytest.fixture(scope="module")
def hybrid_model(hybrid_jax_params):
    model = DPT(TINY_HYBRID)
    model.load_state_dict(params_from_jax(hybrid_jax_params, TINY_HYBRID))
    return model.eval()


def test_hybrid_params_from_jax_inverts_convert_dpt(hybrid_hub_sd, hybrid_jax_params):
    sd = params_from_jax(hybrid_jax_params, TINY_HYBRID)
    assert sorted(sd) == sorted(hybrid_hub_sd)
    for k, v in hybrid_hub_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_hybrid_state_dict_keys_are_hub_keys(hybrid_hub_sd):
    shapes = {k: tuple(v.shape) for k, v in DPT(TINY_HYBRID).state_dict().items()}
    assert shapes == {k: v.shape for k, v in hybrid_hub_sd.items()}
    assert not any(k.startswith(("pretrained.act_postprocess1.", "pretrained.act_postprocess2.")) for k in shapes)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)], ids=["native_grid", "pos_embed_resized"])
def test_hybrid_forward_matches_jax(rng, hybrid_jax_params, hybrid_model, hw):
    """Max-scaled 1e-4, the JAX package's own tolerance for the hybrid (tests/test_dpt.py)."""
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JaxDPT(JAX_TINY_HYBRID).apply)({"params": hybrid_jax_params}, x))
    with torch.inference_mode():
        got = hybrid_model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.shape == ref.shape == (1, *hw)
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)


@pytest.mark.parametrize("hw", [(64, 96), (63, 77)], ids=["even", "odd"])
def test_resnetv2_stem_matches_jax(rng, hybrid_jax_params, hybrid_model, hw):
    """The stem alone: at an even size the 7×7/2 conv pads (2, 3), the
    stride-2 3×3 convs (0, 1) and the max pool (0, 1) with −inf; at an odd
    size they pad symmetrically."""
    stem = hybrid_model.pretrained.model.patch_embed.backbone
    assert isinstance(stem, ResNetV2Stem)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    ref_out, ref_levels = jax.jit(JaxResNetV2Stem().apply)({"params": hybrid_jax_params["resnet_stem"]}, x)
    with torch.inference_mode():
        out, levels = stem(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(levels) == len(ref_levels) == 2
    for got, ref in zip([*levels, out], [*ref_levels, ref_out]):
        got, ref = got.numpy().transpose(0, 2, 3, 1), np.asarray(ref)
        assert got.shape == ref.shape
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)


def test_std_conv_standardizes_the_current_weight(hybrid_model, rng):
    """Each forward standardizes the raw weight it holds now (mean 0, population
    variance 1 per output channel, eps 1e-6 as in the JAX package); the state
    dict holds the raw weight, and a changed weight changes the next forward."""
    conv = hybrid_model.pretrained.model.patch_embed.backbone.stem.conv
    raw = conv.weight.detach().clone()
    w = raw.double()
    mean, var = w.mean((1, 2, 3), keepdim=True), w.var((1, 2, 3), correction=0, keepdim=True)
    torch.testing.assert_close(standardize(raw).double(), (w - mean) / torch.sqrt(var + 1e-6), atol=1e-5, rtol=0)
    torch.testing.assert_close(hybrid_model.state_dict()[
        "pretrained.model.patch_embed.backbone.stem.conv.weight"], raw, atol=0, rtol=0)
    x = torch.from_numpy(rng.standard_normal((1, 3, 32, 32)).astype(np.float32))
    with torch.inference_mode():
        y1 = conv(x)
    try:
        with torch.no_grad():
            conv.weight.add_(1.0)  # standardization removes a shift
            y2 = conv(x)
            conv.weight[0].neg_()
            y3 = conv(x)
    finally:
        with torch.no_grad():
            conv.weight.copy_(raw)
    torch.testing.assert_close(y2, y1, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y3[:, 1:], y1[:, 1:], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y3[:, 0], -y1[:, 0], atol=1e-4, rtol=1e-4)