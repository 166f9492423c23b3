"""The port's frame-path ops (depth_estimation_tpu_torch.ops) against the JAX
package's, on the CPU, from the same numpy inputs."""

import numpy as np
import pytest
import torch

from depth_estimation_tpu import config as jcfg
from depth_estimation_tpu.ops import postprocess as jpost
from depth_estimation_tpu.ops import preprocess as jpre
from depth_estimation_tpu.ops import resize as jresize
from depth_estimation_tpu_torch import config as tcfg
from depth_estimation_tpu_torch.ops import postprocess as tpost
from depth_estimation_tpu_torch.ops import preprocess as tpre
from depth_estimation_tpu_torch.ops import resize as tresize
from depth_estimation_tpu_torch.ops.kernels.resize import band_taps

SIZES = [(1, 1), (1, 7), (3, 5), (5, 3), (4, 9), (24, 48), (96, 120), (120, 96),
         (384, 480), (480, 384), (512, 640), (640, 512), (577, 769)]
METHODS = [("cubic", False), ("cubic", True), ("linear", False), ("linear", True)]
CONFIGS = {"dpt": "DPT_PREPROCESS", "small": "SMALL_PREPROCESS", "default": "DEFAULT_PREPROCESS"}


@pytest.mark.parametrize("method,align_corners", METHODS)
def test_interp_matrix_bit_identical(method, align_corners):
    for i, o in SIZES:
        np.testing.assert_array_equal(
            tresize.interp_matrix(i, o, method, align_corners),
            jresize.interp_matrix(i, o, method, align_corners))


@pytest.mark.parametrize("method,align_corners", METHODS)
def test_band_taps_densify_to_interp_matrix(method, align_corners):
    for i, o in SIZES:
        idx, w = band_taps(i, o, method, align_corners)
        assert idx.shape == w.shape == (o, 4)
        assert idx.dtype == np.int32 and w.dtype == np.float32
        assert idx.min() >= 0 and idx.max() < i
        dense = np.zeros((o, i), np.float32)
        np.add.at(dense, (np.arange(o)[:, None], idx), w)
        np.testing.assert_array_equal(dense, jresize.interp_matrix(i, o, method, align_corners))


# the main paths' resize pairs (frame → network input → frame) and ragged ones
BAND_PAIRS = [(640, 512), (512, 640), (480, 384), (384, 480), (640, 256), (480, 192), (192, 480), (256, 640),
              (3, 7), (5, 2), (1, 7), (577, 769)]


@pytest.mark.parametrize("method,align_corners", [("cubic", False), ("linear", True)])
@pytest.mark.parametrize("in_size,out_size", BAND_PAIRS)
def test_band_taps_pad_inside_the_band(in_size, out_size, method, align_corners):
    """Each row's 4 indices are non-decreasing and lie within its first and
    last nonzero column, so a tile's input window holds every tap it reads."""
    idx, _ = band_taps(in_size, out_size, method, align_corners)
    nonzero = jresize.interp_matrix(in_size, out_size, method, align_corners) != 0
    first = nonzero.argmax(axis=1)
    last = in_size - 1 - nonzero[:, ::-1].argmax(axis=1)
    assert (np.diff(idx, axis=1) >= 0).all()
    assert (idx >= first[:, None]).all() and (idx <= last[:, None]).all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compute_resize_shape_matches(name):
    tc, jc = getattr(tcfg, CONFIGS[name]), getattr(jcfg, CONFIGS[name])
    sides = [1, 31, 64, 100, 120, 160, 240, 320, 360, 384, 480, 481, 500, 640, 720, 1080, 1920]
    for h in sides:
        for w in sides:
            assert tpre.compute_resize_shape(h, w, tc) == jpre.compute_resize_shape(h, w, jc), (h, w)


def test_preprocess_configs_match():
    for name in CONFIGS.values():
        assert getattr(tcfg, name) == tcfg.PreprocessConfig(**vars(getattr(jcfg, name)))


@pytest.mark.parametrize("method,align_corners", METHODS)
@pytest.mark.parametrize("shape,out_hw", [((2, 48, 64, 3), (60, 80)), ((2, 96, 128, 3), (48, 64)),
                                          ((96, 128), (120, 160))])
def test_resize2d_matches_jax(rng, method, align_corners, shape, out_hw):
    x = rng.random(shape).astype(np.float32)
    got = tresize.resize2d(torch.from_numpy(x), out_hw, method, align_corners).numpy()
    ref = np.asarray(jresize.resize2d(x, out_hw, method, align_corners))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-5)


@pytest.mark.parametrize("name", ["DPT_PREPROCESS", "SMALL_PREPROCESS"])
def test_preprocess_matches_jax(rng, name):
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    got = tpre.preprocess(img, getattr(tcfg, name), device="cpu").numpy()
    ref = np.asarray(jpre.preprocess(img, getattr(jcfg, name)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-5)


def test_preprocess_refuses_cuda_without_gpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tpre.preprocess(rng.integers(0, 256, (32, 32, 3), np.uint8), tcfg.DPT_PREPROCESS)


def test_wraparound_u8_matches_jax(rng):
    edge = np.array([-1e4, -257.0, -256.5, -256.0, -255.9, -1.5, -1.0, -0.5, -0.0, 0.0, 0.5,
                     1.0, 127.9, 254.9, 255.0, 255.9, 256.0, 256.1, 511.99, 512.0, 1e4,
                     12345.678], np.float32)
    x = np.concatenate([edge, (rng.standard_normal(4096) * 3000).astype(np.float32)])
    got = tpost.wraparound_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpost.wraparound_u8_jax(x)))
    assert got.dtype == np.uint8


def test_host_postprocess_matches_jax(rng):
    d = (rng.random((24, 32)) * 600 - 50).astype(np.float32)
    for faithful in (True, False):
        np.testing.assert_array_equal(tpost.depth_to_gray_u8(d, faithful), jpost.depth_to_gray_u8(d, faithful))
    g = rng.integers(0, 256, (24, 32), np.uint8)
    np.testing.assert_array_equal(tpost.merge_gray3(g), jpost.merge_gray3(g))
