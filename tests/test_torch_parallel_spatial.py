"""Spatial partitioning of the port (``parallel/spatial.py``,
``DepthEstimator.predict_spatial``) against the JAX package, the
counterpart of tests/test_parallel_spatial.py.

On eight gloo ranks (one spawned world for the module,
``tests/torch_parallel_ranks.py``): the tiny MiDaS v2.1 of JAX's test at
64×96 with every layer's rows cut over 8 and over 4 ranks against JAX's
unsharded ``MidasV21(TINY).apply`` (2e-5 abs, JAX's own; at 8 ranks the
stride-32 layer's 2 rows leave six ranks empty), and MiDaS_small's
``predict_spatial`` at 96×128 over 8 ranks against JAX's ``predict``
(max-scaled 2e-5). Then the two refusals, the row rules in one process, and
K2 and K3 on row windows against their whole-frame results."""

import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.midas_v21 import MidasV21 as JaxMidasV21
from depth_estimation_tpu.utils.convert import convert_midas_small, convert_midas_v21
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.models.midas_v21 import MidasV21
from depth_estimation_tpu_torch.ops.kernels import resize as trsz
from depth_estimation_tpu_torch.parallel.launch import spawn
from depth_estimation_tpu_torch.parallel.spatial import RowWorld, conv, row_bounds, spatial_forward
from depth_estimation_tpu_torch.utils.convert import params_from_jax_midas_small, params_from_jax_midas_v21
from tests.oracles import midas_v21_torch as v21_oracle
from tests.test_torch_estimator_small_hybrid import _hub_sd as small_hub_sd
from tests.test_torch_midas_v21 import JAX_TINY, TINY, TINY_FIELDS
from tests.torch_parallel_ranks import spatial_world


@pytest.fixture(scope="module")
def v21_params():
    hub = {k: v.numpy() for k, v in v21_oracle.make_random_state_dict(JAX_TINY, seed=7).items()}
    jparams = convert_midas_v21(hub, JAX_TINY)
    return jparams, {k: v.numpy() for k, v in params_from_jax_midas_v21(jparams, TINY).items()}


@pytest.fixture(scope="module")
def small_params():
    jparams = convert_midas_small(small_hub_sd("MiDaS_small", seed=5))
    return jparams, {k: v.numpy() for k, v in params_from_jax_midas_small(jparams).items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    return rng.standard_normal((1, 64, 96, 3)).astype(np.float32), rng.integers(0, 256, (96, 128, 3), np.uint8)


@pytest.fixture(scope="module")
def world(v21_params, small_params, inputs):
    x, img = inputs
    return spawn(spatial_world, 8, "cpu", TINY_FIELDS, v21_params[1], np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
                 small_params[1], img)


@pytest.mark.parametrize("n", [8, 4])
def test_tiny_v21_spatially_sharded_matches_unsharded(world, v21_params, inputs, n):
    """JAX ``test_tiny_v21_spatially_sharded_matches_unsharded`` (2e-5 abs) on every rank."""
    x, _ = inputs
    want = np.asarray(jax.jit(JaxMidasV21(JAX_TINY).apply)({"params": v21_params[0]}, x))
    for r in world:
        assert r[f"v21_tp{n}"].shape == want.shape == (1, 64, 96)
        np.testing.assert_allclose(r[f"v21_tp{n}"], want, atol=2e-5)


def test_eight_ranks_leave_empty_shards():
    """At 64×96, layer 4 (stride 32) has 2 rows: over 8 ranks six hold none."""
    assert [b - a for a, b in row_bounds(64 // 32, 8)] == [1, 1, 0, 0, 0, 0, 0, 0]


def test_estimator_predict_spatial_matches_predict(world, small_params, inputs):
    """JAX ``test_estimator_predict_spatial_matches_predict``: MiDaS_small's
    frame program, its rows over 8 ranks, against JAX's ``predict``
    (max-scaled 2e-5), every rank holding the whole map."""
    import warnings

    _, img = inputs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JaxEstimator("MiDaS_small", params=small_params[0], verbose=False).predict(img)
    scale = np.abs(want).max() + 1e-8
    for r in world:
        assert r["small_tp8"].shape == want.shape == (96, 128) and r["small_tp8"].dtype == np.float32
        np.testing.assert_allclose(r["small_tp8"] / scale, want / scale, atol=2e-5)


def test_predict_spatial_refuses_a_height_that_does_not_divide(world):
    for r in world:
        assert "source height 97 not divisible by mesh axis 'tp' of size 8" in r["tall_error"]


def test_predict_spatial_leaves_the_dpt_families_to_slice_18(world):
    for r in world:
        assert r["dpt_error"].startswith("DPT: ") and "slice 18" in r["dpt_error"]


# -- the row rules in one process -------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 5, 13])
def test_local_world_matches_the_unpartitioned_forward(v21_params, n):
    """The compute half alone (chip_smoke's ``parallel_sp`` runs it so on the
    card): every rank in one process, the exchanges slicing the whole tensor;
    more ranks than rows at 13."""
    model = MidasV21(TINY)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in v21_params[1].items()})
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, 3, 64, 96)).astype(np.float32))
    with torch.no_grad():
        want = model.eval()(x)
        got = spatial_forward(RowWorld.local(n), model, x)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_exchange_fetches_only_the_rows_a_rank_reads():
    """A 3×3 stride-1 conv over 4 ranks of 16 rows: rank r computes rows
    4r … 4r+3 from rows 4r−1 … 4r+4, one halo row from each neighbour."""
    world = RowWorld.local(4)
    x = world.shard(torch.randn((1, 2, 16, 5)), 2)
    fetched = {}
    fetch = world.fetch

    def recording(rows, needs):
        fetched.update(needs)
        return fetch(rows, needs)

    world.fetch = recording
    w = torch.randn((3, 2, 3, 3))
    got = world.gather(conv(world, x, w, None, 1, (1, 1), (1, 1)))
    assert fetched == {0: (0, 5), 1: (3, 9), 2: (7, 13), 3: (11, 16)}
    torch.testing.assert_close(got, torch.nn.functional.conv2d(world.gather(x), w, padding=1))


# -- K2 and K3 on output-row windows ------------------------------------------


@pytest.mark.parametrize("rows", [(0, 9), (9, 20), (31, 32)])
def test_preprocess_window_is_the_whole_frames_rows(rows):
    """K2's plain version on a window of output rows, from the source rows
    it reads, against the whole frame's (bitwise: the same products)."""
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 48, 40, 3), np.uint8))
    r0, r1 = rows
    lo, hi = trsz.window_rows(48, 32, r0, r1)
    whole = trsz.fused_preprocess(imgs, (32, 48), DPT_PREPROCESS.mean, DPT_PREPROCESS.std)
    got = trsz.fused_preprocess(imgs[:, lo:hi], (32, 48), DPT_PREPROCESS.mean, DPT_PREPROCESS.std,
                                window=(r0, r1, 48, lo))
    torch.testing.assert_close(got, whole[:, :, r0:r1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("rows", [(0, 13), (13, 40), (39, 40)])
def test_resize_window_is_the_whole_maps_rows_and_its_gradient(rows):
    """K3's plain version on a window, against the whole map's rows, and its
    registered backward against the whole map's gradient on the slab."""
    planes = torch.from_numpy(np.random.default_rng(2).random((2, 24, 32)).astype(np.float32))
    r0, r1 = rows
    lo, hi = trsz.window_rows(24, 40, r0, r1)
    whole = planes.clone().requires_grad_()
    slab = planes[:, lo:hi].clone().requires_grad_()
    got = trsz.resize_planes(slab, (40, 56), window=(r0, r1, 24, lo))
    want = trsz.resize_planes(whole, (40, 56))[:, r0:r1]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(got.shape).astype(np.float32))
    got.backward(g)
    want.backward(g)
    torch.testing.assert_close(slab.grad, whole.grad[:, lo:hi], atol=1e-5, rtol=0)
    assert not whole.grad[:, :lo].any() and not whole.grad[:, hi:].any()


def test_windows_refuse_a_slab_that_misses_rows():
    with pytest.raises(ValueError, match="the slab holds"):
        trsz.resize_planes(torch.zeros((1, 4, 32)), (40, 56), window=(0, 13, 24, 1))
    with pytest.raises(ValueError, match="outside the 40 output rows"):
        trsz.resize_planes(torch.zeros((1, 24, 32)), (40, 56), window=(30, 41, 24, 0))


def test_window_tiling_runs_on_the_windows_rows():
    """``tiling`` over a window: the grid covers its rows only, and each
    tile's staged rows lie inside the slab (what the kernel stages, from
    the same formulas as tests/test_torch_kernels.py's tilings)."""
    lo, hi = trsz.window_rows(192, 480, 120, 240)
    t = trsz.tiling((192, 256), (480, 640), 1, 132, "resize", "cubic", False, (120, 240, lo))
    assert t["grid"][1] * t["th"] >= 120 > (t["grid"][1] - 1) * t["th"]
    idx, _ = trsz.window_taps(192, 480, "cubic", False, 120, 240, lo)
    assert idx.min() >= 0 and idx.max() < hi - lo and t["rows"] <= hi - lo
