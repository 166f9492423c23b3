"""The port's DepthEstimator and VidStream with a tiny "MiDaS" (v2.1)
against the JAX package's, on the same weights, on the CPU; and hub
checkpoints, whose unread keys the estimator drops, for MiDaS and DPT."""

import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import SMALL_PREPROCESS as JAX_SMALL_PREPROCESS
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.midas_v21 import MidasV21 as JaxMidasV21
from depth_estimation_tpu.runtime.stream import VidStream as JaxVidStream
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu.utils.convert import convert_midas_v21
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS, SMALL_PREPROCESS
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.models.midas_v21 import MidasV21
from depth_estimation_tpu_torch.runtime.stream import VidStream
from depth_estimation_tpu_torch.runtime.video import NullSink
from depth_estimation_tpu_torch.utils.convert import params_from_jax_midas_v21
from tests.oracles import dpt_torch as dpt_oracle
from tests.oracles import midas_v21_torch as oracle
from tests.test_torch_dpt import JAX_TINY as JAX_DPT_TINY
from tests.test_torch_dpt import TINY as DPT_TINY
from tests.test_torch_estimator import _assert_u8_agrees, _collector, _frames
from tests.test_torch_midas_v21 import JAX_TINY, TINY

NAME = "MiDaS_Tiny_port_test"
DPT_NAME = "DPT_Tiny_hub_keys_test"
H, W = 120, 160


@pytest.fixture(scope="module")
def hub_sd():
    sd = {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY, seed=3).items()}
    # depth up to ~80, so the u8 bytes carry information (as tests/test_torch_estimator.py)
    for k in ("scratch.output_conv.4.weight", "scratch.output_conv.4.bias"):
        sd[k] = sd[k] * 15
    return sd


@pytest.fixture(scope="module")
def estimators(hub_sd):
    jreg.register(jreg.ModelEntry(NAME, lambda: JaxMidasV21(JAX_TINY), JAX_SMALL_PREPROCESS,
                                  lambda sd: convert_midas_v21(sd, JAX_TINY)))
    treg.register(treg.ModelEntry(NAME, lambda: MidasV21(TINY), SMALL_PREPROCESS))
    jax_params = convert_midas_v21(hub_sd, JAX_TINY)
    ref = JaxEstimator(NAME, params=jax_params, verbose=False)
    port = DepthEstimator(NAME, params=params_from_jax_midas_v21(jax_params, TINY), verbose=False, device="cpu")
    return ref, port


def test_predict_matches_jax(rng, estimators):
    ref, port = estimators
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    want, got = ref.predict(img), port.predict(img)
    assert got.shape == want.shape == (H, W) and got.dtype == np.float32
    assert np.abs(want).max() > 20  # the u8 tests below see more than a few levels
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_predict_batch_matches_jax(rng, estimators):
    ref, port = estimators
    imgs = rng.integers(0, 256, (2, H, W, 3), np.uint8)
    want, got = ref.predict_batch(imgs), port.predict_batch(imgs)
    assert got.shape == want.shape == (2, H, W)
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_predict_device_u8_matches_jax(rng, estimators):
    ref, port = estimators
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    got = port.predict_device_u8(img)
    _assert_u8_agrees(got.numpy(), np.asarray(ref.predict_device_u8(img)), ref.predict(img))


@pytest.mark.parametrize("microbatch", [1, 3])
def test_vidstream_frames_match_jax(estimators, microbatch):
    ref, port = estimators
    want, got = _collector(JaxNullSink), _collector(NullSink)
    JaxVidStream(ref, f"synthetic:6x{H}x{W}", want, verbose=False, microbatch=microbatch).update()
    VidStream(port, f"synthetic:6x{H}x{W}", got, verbose=False, microbatch=microbatch).update()
    assert len(got.frames) == len(want.frames) == 6
    for frame, g, w in zip(_frames(6), got.frames, want.frames):
        assert g.shape == (H, W, 3)
        _assert_u8_agrees(g, w, np.repeat(ref.predict(frame)[..., None], 3, axis=-1))


def test_bfloat16_estimator_close_to_f32(rng, estimators):
    _, port = estimators
    e16 = DepthEstimator(NAME, params=port.model.state_dict(), dtype="bfloat16", verbose=False, device="cpu")
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    d32, d16 = port.predict(img), e16.predict(img)
    assert np.abs(d32 - d16).max() / np.abs(d32).max() < 0.1


def test_random_init_puts_batch_norm_at_identity():
    with pytest.warns(UserWarning, match="random"):
        est = DepthEstimator(NAME, seed=0, verbose=False, device="cpu")
    bn = est.model.pretrained.layer2[0].bn2
    assert torch.equal(bn.weight, torch.ones_like(bn.weight)) and torch.equal(bn.running_var, bn.weight)
    assert not bn.bias.any() and not bn.running_mean.any()
    conv2 = est.model.pretrained.layer1[4][0].conv2.weight
    assert torch.isfinite(conv2).all() and 0.1 < conv2.std() * (conv2[0].numel() ** 0.5) < 10


# -- hub checkpoints: the keys the forward never reads ---------------------------

def _hub_dicts():
    """(model name, registry entry, the tiny hub state dict) for MiDaS and DPT."""
    midas = {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY, seed=5).items()}
    dpt = {k: v.numpy() for k, v in dpt_oracle.make_random_state_dict(JAX_DPT_TINY, seed=5).items()}
    return {
        NAME: (treg.ModelEntry(NAME, lambda: MidasV21(TINY), SMALL_PREPROCESS), midas),
        DPT_NAME: (treg.ModelEntry(DPT_NAME, lambda: DPT(DPT_TINY), DPT_PREPROCESS), dpt),
    }


def _with_unread_keys(sd):
    """What a hub checkpoint adds: BatchNorm step counters (one per norm
    layer, as torch.nn.BatchNorm2d saves them), refinenet4's dead first unit
    and, in a DPT, the timm ViT's final LayerNorm and 1000-class head."""
    f = sd["scratch.refinenet4.resConfUnit2.conv1.weight"].shape[0]
    extra = {k[:-len("running_var")] + "num_batches_tracked": np.array(7) for k in sd if k.endswith("running_var")}
    extra["pretrained.model.norm.num_batches_tracked"] = np.array(0)
    if "pretrained.model.cls_token" in sd:
        c = sd["pretrained.model.cls_token"].shape[-1]
        extra.update({"pretrained.model.norm.weight": np.ones(c, np.float32),
                      "pretrained.model.norm.bias": np.zeros(c, np.float32),
                      "pretrained.model.head.weight": np.ones((1000, c), np.float32),
                      "pretrained.model.head.bias": np.ones(1000, np.float32)})
    for conv in ("conv1", "conv2"):
        extra[f"scratch.refinenet4.resConfUnit1.{conv}.weight"] = np.ones((f, f, 3, 3), np.float32)
        extra[f"scratch.refinenet4.resConfUnit1.{conv}.bias"] = np.ones(f, np.float32)
    return {**sd, **extra}


@pytest.mark.parametrize("name", [NAME, DPT_NAME])
def test_hub_checkpoint_with_unread_keys_loads(rng, name):
    entry, sd = _hub_dicts()[name]
    treg.register(entry)
    full = _with_unread_keys(sd)
    assert len(full) > len(sd) + 4
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    want = DepthEstimator(name, params=sd, verbose=False, device="cpu").predict(img)
    got = DepthEstimator(name, params=full, verbose=False, device="cpu").predict(img)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [NAME, DPT_NAME])
def test_other_unknown_or_missing_keys_raise(name):
    entry, sd = _hub_dicts()[name]
    treg.register(entry)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        DepthEstimator(name, params={**sd, "scratch.refinenet3.extra.weight": np.zeros(1)}, verbose=False,
                       device="cpu")
    missing = dict(sd)
    missing.pop("scratch.refinenet3.resConfUnit1.conv1.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        DepthEstimator(name, params=missing, verbose=False, device="cpu")
