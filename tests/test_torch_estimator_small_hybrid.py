"""The port's DepthEstimator and VidStream for MiDaS_small (full width) and
DPT_Hybrid (the JAX package's tiny hybrid: ResNetV2-50 stem at full width, a
tiny ViT) against the JAX package's, on the same weights, on the CPU; the
registry's four families; and the random DPT_Hybrid at full width."""

import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import DPT_PREPROCESS as JAX_DPT_PREPROCESS
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.runtime.stream import VidStream as JaxVidStream
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu.utils.convert import convert_dpt, convert_midas_small
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS, SMALL_PREPROCESS
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.runtime.stream import VidStream
from depth_estimation_tpu_torch.runtime.video import NullSink
from depth_estimation_tpu_torch.utils.convert import params_from_jax
from tests.oracles import dpt_torch as dpt_oracle
from tests.oracles import midas_small_torch as small_oracle
from tests.test_torch_dpt import JAX_TINY_HYBRID, TINY_HYBRID
from tests.test_torch_estimator import _assert_u8_agrees, _collector, _frames
from tests.test_torch_estimator_midas import _with_unread_keys

HYBRID = "DPT_Hybrid_Tiny_port_test"
H, W = 120, 160
# Per family: the factor on the head's last conv, so that depth reaches at
# least ``min_depth`` and the u8 bytes carry information; and the max-scaled
# tolerance of the f32 maps. The hybrid's 16 GroupNorm bottlenecks make its
# f32 map noisy in either package: at the 288×384 network input the JAX
# package lies up to 1.2e-4 (max-scaled) from a float64 run of the same weights
# and the port 7.5e-5, so the two are held at 2e-4, and its depth is kept
# under 10 so that their f32 maps stay within the 1e-3 the u8 rule allows.
FAMILIES = {"MiDaS_small": dict(scale=200, min_depth=20, atol=1e-4),
            HYBRID: dict(scale=2, min_depth=3, atol=2e-4)}


def _hub_sd(name, seed):
    if name == "MiDaS_small":
        sd = {k: v.numpy() for k, v in small_oracle.make_random_state_dict(seed=seed).items()}
    else:
        sd = {k: v.numpy() for k, v in dpt_oracle.make_random_state_dict(JAX_TINY_HYBRID, seed=seed).items()}
    for k in ("scratch.output_conv.4.weight", "scratch.output_conv.4.bias"):
        sd[k] = sd[k] * FAMILIES[name]["scale"]
    return sd


def _register_hybrid():
    jreg.register(jreg.ModelEntry(HYBRID, lambda: JaxDPT(JAX_TINY_HYBRID), JAX_DPT_PREPROCESS,
                                  lambda sd: convert_dpt(sd, JAX_TINY_HYBRID)))
    treg.register(treg.ModelEntry(HYBRID, lambda: DPT(TINY_HYBRID), DPT_PREPROCESS))


@pytest.fixture(scope="module", params=["MiDaS_small", HYBRID])
def estimators(request):
    """(JAX estimator, port estimator on the CPU) on one random hub state dict:
    the JAX side through its converter, the port's from the hub keys as they are
    for MiDaS_small and through ``params_from_jax`` for the hybrid."""
    name = request.param
    sd = _hub_sd(name, seed=3)
    if name == "MiDaS_small":
        jax_params, port_params = convert_midas_small(sd), sd
    else:
        _register_hybrid()
        jax_params = convert_dpt(sd, JAX_TINY_HYBRID)
        port_params = params_from_jax(jax_params, TINY_HYBRID)
    ref = JaxEstimator(name, params=jax_params, verbose=False)
    port = DepthEstimator(name, params=port_params, verbose=False, device="cpu")
    return ref, port


def _assert_max_scaled(got, want, atol):
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def test_predict_matches_jax(rng, estimators):
    ref, port = estimators
    fam = FAMILIES[port.model_type]
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    want, got = ref.predict(img), port.predict(img)
    assert got.shape == (H, W)
    assert np.abs(want).max() > fam["min_depth"]  # the u8 tests below see more than a few levels
    _assert_max_scaled(got, want, fam["atol"])


def test_predict_batch_matches_jax(rng, estimators):
    ref, port = estimators
    imgs = rng.integers(0, 256, (2, H, W, 3), np.uint8)
    want, got = ref.predict_batch(imgs), port.predict_batch(imgs)
    assert got.shape == (2, H, W)
    _assert_max_scaled(got, want, FAMILIES[port.model_type]["atol"])


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


def _bf16_tail_distance(e32, e16, img):
    """The hybrid's bf16 ViT and decoder fed the f32 stem's features (cast to
    bf16): max-scaled distance of the map from the f32 one."""
    kept = {}
    stem32 = e32.model.pretrained.model.patch_embed.backbone
    stem16 = e16.model.pretrained.model.patch_embed.backbone
    hooks = [stem32.register_forward_hook(lambda mod, inp, out: kept.update(out=out)),
             stem16.register_forward_hook(lambda mod, inp, out: (
                 kept["out"][0].to(out[0].dtype), [t.to(out[0].dtype) for t in kept["out"][1]]))]
    try:
        d32, d16 = e32.predict(img), e16.predict(img)
    finally:
        for h in hooks:
            h.remove()
    return np.abs(d32 - d16).max() / np.abs(d32).max()


def test_bfloat16_estimator_close_to_f32(rng, estimators):
    """bf16 has no parity gate; its map stays within a fixed distance of the
    f32 map's range. MiDaS_small: 0.1 (0.02-0.05 measured). The random tiny
    hybrid's stem amplifies bf16 rounding block by block (the whole map lies
    0.42-0.59 from f32 on four frames, the JAX package's own bf16 0.41-0.63),
    so its map is held at 0.75, and its ViT and decoder fed the f32 stem's
    features, which do not amplify, at 0.05 (0.020-0.030 measured)."""
    _, port = estimators
    e16 = DepthEstimator(port.model_type, params=port.model.state_dict(), dtype="bfloat16", verbose=False,
                         device="cpu")
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    d32, d16 = port.predict(img), e16.predict(img)
    assert d16.dtype == np.float32 and np.isfinite(d16).all()
    dist = np.abs(d32 - d16).max() / np.abs(d32).max()
    if port.model_type == "MiDaS_small":
        assert dist < 0.1
    else:
        assert dist < 0.75
        assert _bf16_tail_distance(port, e16, img) < 0.05


@pytest.mark.parametrize("name", ["MiDaS_small", HYBRID])
def test_hub_checkpoint_with_unread_keys_loads(rng, name):
    """BatchNorm step counters (one for each of Lite3's batch norms) and
    refinenet4's dead first unit are dropped; the map is the same as without them."""
    if name == HYBRID:
        _register_hybrid()
    sd = _hub_sd(name, seed=5)
    full = _with_unread_keys(sd)
    assert len(full) > len(sd) + 4
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    want = DepthEstimator(name, params=sd, verbose=False, device="cpu").predict(img)
    got = DepthEstimator(name, params=full, verbose=False, device="cpu").predict(img)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["DPT_Large", "DPT_Hybrid", "MiDaS_small", "MiDaS"])
def test_registry_builds_every_family(name):
    with torch.device("meta"):
        model = treg.get_entry(name).make_model()
    assert sum(p.numel() for p in model.parameters()) > 1e7
    assert treg.get_entry(name).preprocess == (DPT_PREPROCESS if name.startswith("DPT") else SMALL_PREPROCESS)


def test_full_width_state_dicts_are_the_hub_layouts():
    """DPT_Hybrid and MiDaS_small at full width hold exactly the hub keys and
    shapes of the oracles' hub state dicts."""
    from depth_estimation_tpu.models.dpt import DPT_HYBRID as JAX_DPT_HYBRID

    for name, hub in [("DPT_Hybrid", dpt_oracle.make_random_state_dict(JAX_DPT_HYBRID, seed=0)),
                      ("MiDaS_small", small_oracle.make_random_state_dict(seed=0))]:
        with torch.device("meta"):
            model = treg.get_entry(name).make_model()
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: v.shape for k, v in hub.items()}


def test_random_dpt_hybrid_is_finite_and_not_all_zero():
    """GroupNorm starts at the identity in random weights; at 0.02·N(0, 1) it
    nearly zeroed every stage of the ResNet stem."""
    with pytest.warns(UserWarning, match="random"):
        est = DepthEstimator("DPT_Hybrid", seed=0, verbose=False, device="cpu")
    gn = est.model.pretrained.model.patch_embed.backbone.stages[1].blocks[0].norm2
    assert torch.equal(gn.weight, torch.ones_like(gn.weight)) and not gn.bias.any()
    depth = est.predict(np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8))
    assert depth.shape == (48, 64) and np.isfinite(depth).all()
    assert np.abs(depth).max() > 0.1 and (depth != 0).mean() > 0.1
