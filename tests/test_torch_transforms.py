"""The port's torch.hub ``transforms`` surface against the JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

from depth_estimation_tpu import transforms as jtr
from depth_estimation_tpu_torch import transforms as ttr

NAMES = ["dpt_transform", "small_transform", "default_transform"]


@pytest.mark.parametrize("kind", ["u8", "float"])
@pytest.mark.parametrize("name", NAMES)
def test_transform_matches_jax(rng, name, kind):
    """The same RGB image, u8 or float in [0, 1] (out-of-range values clip),
    gives the same NHWC float32 batch."""
    if kind == "u8":
        img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    else:
        img = rng.uniform(-0.1, 1.1, (120, 160, 3)).astype(np.float32)
    got = getattr(ttr, name)(img, device="cpu")
    ref = np.asarray(getattr(jtr, name)(img))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == ref.shape and got.shape[0] == 1 and got.shape[-1] == 3
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5)


def test_float_input_is_scaled_clipped_and_truncated_as_jax():
    img = np.array([[[-0.5, 0.0, 0.0039], [0.5, 0.99999, 1.0], [1.5, 0.25, 0.7]]], np.float32)
    np.testing.assert_array_equal(ttr._as_u8(img), jtr._as_u8(img))
    u8 = np.arange(9, dtype=np.uint8).reshape(1, 3, 3)
    assert ttr._as_u8(u8) is u8


def test_transforms_default_to_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ttr.small_transform(rng.integers(0, 256, (32, 32, 3), np.uint8))
