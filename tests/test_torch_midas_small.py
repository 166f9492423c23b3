"""The port's MiDaS_small (EfficientNet-Lite3 + fusion decoder) against the JAX
package's on the same weights, on the CPU. The family has no width knob, so
it runs at full width on small inputs, 192×256 being the real network size,
where the stride-2 convs pad asymmetrically."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depth_estimation_tpu.models.efficientnet_lite import LITE3_STAGES as JAX_LITE3_STAGES
from depth_estimation_tpu.models.efficientnet_lite import EfficientNetLite3 as JaxEfficientNetLite3
from depth_estimation_tpu.models.midas_small import MidasSmall as JaxMidasSmall
from depth_estimation_tpu.utils.convert import convert_midas_small, lite3_hub_prefix as jax_lite3_hub_prefix
from depth_estimation_tpu.utils.convert import midas_small_expected_keys
from depth_estimation_tpu_torch.models.efficientnet_lite import LITE3_STAGES
from depth_estimation_tpu_torch.models.layers import conv2d_same, max_pool3x3s2_same, same_pads
from depth_estimation_tpu_torch.models.midas_small import MidasSmall
from depth_estimation_tpu_torch.utils.convert import lite3_hub_prefix, params_from_jax_midas_small
from tests.oracles import midas_small_torch as oracle


@pytest.fixture(scope="module")
def hub_sd():
    return {k: v.numpy() for k, v in oracle.make_random_state_dict(seed=7).items()}


@pytest.fixture(scope="module")
def jax_params(hub_sd):
    return convert_midas_small(hub_sd)


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = MidasSmall()
    model.load_state_dict(params_from_jax_midas_small(jax_params))
    return model.eval()


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _assert_max_scaled(got, ref, atol):
    assert got.shape == ref.shape
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(got / scale, ref / scale, atol=atol)


def test_params_from_jax_inverts_convert_midas_small(hub_sd, jax_params):
    sd = params_from_jax_midas_small(jax_params)
    assert sorted(sd) == sorted(hub_sd)
    for k, v in hub_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_state_dict_keys_are_the_expected_hub_keys(hub_sd):
    shapes = {k: tuple(v.shape) for k, v in MidasSmall().state_dict().items()}
    assert sorted(shapes) == sorted(midas_small_expected_keys())
    assert shapes == {k: v.shape for k, v in hub_sd.items()}


def test_lite3_layout_matches_jax():
    assert LITE3_STAGES == JAX_LITE3_STAGES
    for si, (_, reps, *_rest) in enumerate(LITE3_STAGES):
        for bi in range(reps):
            assert lite3_hub_prefix(si, bi) == jax_lite3_hub_prefix(si, bi)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128), (192, 256)])
def test_encoder_taps_match_jax(rng, jax_params, port_model, hw):
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    ref = jax.jit(JaxEfficientNetLite3().apply)({"params": jax_params["pretrained"]}, x)
    with torch.inference_mode():
        got = port_model.pretrained(_nchw(x))
    for tap, g in zip(("layer1", "layer2", "layer3", "layer4"), got):
        _assert_max_scaled(g.numpy().transpose(0, 2, 3, 1), np.asarray(ref[tap]), 2e-5)


@pytest.mark.parametrize("hw,atol", [((64, 64), 2e-5), ((96, 128), 2e-5), ((192, 256), 5e-5)])
def test_forward_matches_jax(rng, jax_params, port_model, hw, atol):
    """The JAX package's own tolerances against the torch oracle
    (tests/test_midas_small.py): max-scaled 2e-5, and 5e-5 at 192×256."""
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JaxMidasSmall().apply)({"params": jax_params}, x))
    with torch.inference_mode():
        got = port_model(_nchw(x)).numpy()
    assert got.shape == (1, *hw)
    _assert_max_scaled(got, ref, atol)


@pytest.mark.parametrize("size", [64, 96, 65, 97, 7])
@pytest.mark.parametrize("k,stride", [(3, 2), (5, 2), (3, 1), (5, 1), (7, 2)])
def test_same_pads_match_tf(size, k, stride):
    """TF's SAME: ceil(size / stride) outputs, the odd pad after (at stride 2
    and an even size, 3×3 pads (0, 1) and 5×5 pads (1, 2))."""
    lo, hi = same_pads(size, k, stride)
    assert hi - lo in (0, 1) and (size + lo + hi - k) // stride + 1 == -(-size // stride)
    if stride == 2 and size % 2 == 0 and k in (3, 5):
        assert (lo, hi) == (k // 2 - 1, k // 2)


@pytest.mark.parametrize("hw", [(12, 16), (11, 13), (12, 13)])
@pytest.mark.parametrize("k,stride,depthwise", [(3, 2, True), (5, 2, True), (5, 1, True), (3, 2, False)])
def test_conv2d_same_matches_oracle(rng, hw, k, stride, depthwise):
    x = torch.from_numpy(rng.standard_normal((2, 8, *hw)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 1 if depthwise else 8, k, k)).astype(np.float32))
    groups = 8 if depthwise else 1
    torch.testing.assert_close(conv2d_same(x, w, stride=stride, groups=groups),
                               oracle.tf_same_conv(x, w, stride=stride, groups=groups), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hw", [(12, 16), (11, 13), (12, 13), (2, 3)])
def test_max_pool_same_pads_with_minus_inf(rng, hw):
    x = torch.from_numpy(rng.standard_normal((1, 4, *hw)).astype(np.float32)) - 10  # all negative
    (t, b), (l, r) = same_pads(hw[0], 3, 2), same_pads(hw[1], 3, 2)
    want = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, stride=2)
    torch.testing.assert_close(max_pool3x3s2_same(x), want, atol=0, rtol=0)
