"""Spatial partitioning of the port (``parallel/spatial.py``,
``DepthEstimator.predict_spatial``) against the JAX package, the
counterpart of tests/test_parallel_spatial.py.

On eight gloo ranks (one spawned world for the module,
``tests/torch_parallel_ranks.py``): the tiny MiDaS v2.1 of JAX's test at
64×96 with every layer's rows cut over 8 and over 4 ranks against JAX's
unsharded ``MidasV21(TINY).apply`` (2e-5 abs, JAX's own; at 8 ranks the
stride-32 layer's 2 rows leave six ranks empty), MiDaS_small's
``predict_spatial`` at 96×128 over 8 ranks against JAX's ``predict``
(max-scaled 2e-5), and the tiny DPT's and tiny hybrid's ``predict_spatial``
at 120×160 (a 96×128 network input, a 6×8 patch grid) over 8 and 4 ranks
against JAX's ``predict`` and, over 8, JAX's own ``predict_spatial`` on the
eight-device CPU mesh (max-scaled 1e-4, the hybrid 2e-4). Then the height
refusal, the row rules in one process, and K2 and K3 on row windows against
their whole-frame results."""

import warnings

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh
from torch import nn

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import PreprocessConfig as JaxPreprocessConfig
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.models.midas_v21 import MidasV21 as JaxMidasV21
from depth_estimation_tpu.utils.convert import convert_dpt, convert_midas_small, convert_midas_v21
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
from depth_estimation_tpu_torch.models.midas_v21 import MidasV21
from depth_estimation_tpu_torch.models.resnetv2 import GroupNormAct
from depth_estimation_tpu_torch.ops.kernels import resize as trsz
from depth_estimation_tpu_torch.parallel.launch import spawn
from depth_estimation_tpu_torch.parallel.spatial import RowWorld, apply, conv, row_bounds, spatial_forward
from depth_estimation_tpu_torch.utils.convert import (params_from_jax, params_from_jax_midas_small,
                                                      params_from_jax_midas_v21)
from tests.oracles import dpt_torch as dpt_oracle
from tests.oracles import midas_v21_torch as v21_oracle
from tests.test_torch_dpt import JAX_TINY as JAX_TINY_DPT
from tests.test_torch_dpt import JAX_TINY_HYBRID, TINY_HYBRID_FIELDS
from tests.test_torch_dpt import TINY_FIELDS as DPT_FIELDS
from tests.test_torch_estimator_small_hybrid import _hub_sd as small_hub_sd
from tests.test_torch_midas_v21 import JAX_TINY, TINY, TINY_FIELDS
from tests.torch_parallel_ranks import SPATIAL_DPT_PREPROCESS, spatial_world

# name → (the port's DPTConfig fields, JAX's config, the max-scaled tolerance of the estimator tests)
DPT_FAMILIES = {"DPT_Tiny_spatial_test": (DPT_FIELDS, JAX_TINY_DPT, 1e-4),
                "DPT_Hybrid_Tiny_spatial_test": (TINY_HYBRID_FIELDS, JAX_TINY_HYBRID, 2e-4)}


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
def dpt_params():
    """name → (JAX params, the port's state dict), each from a random hub state dict."""
    out = {}
    for seed, (name, (fields, jax_cfg, _)) in enumerate(DPT_FAMILIES.items(), start=3):
        hub = {k: v.numpy() for k, v in dpt_oracle.make_random_state_dict(jax_cfg, seed=seed).items()}
        jparams = convert_dpt(hub, jax_cfg)
        out[name] = jparams, {k: v.numpy() for k, v in params_from_jax(jparams, DPTConfig(**fields)).items()}
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    return rng.standard_normal((1, 64, 96, 3)).astype(np.float32), rng.integers(0, 256, (96, 128, 3), np.uint8)


@pytest.fixture(scope="module")
def dpt_img():
    return np.random.default_rng(6).integers(0, 256, (120, 160, 3), np.uint8)


@pytest.fixture(scope="module")
def world(v21_params, small_params, dpt_params, inputs, dpt_img):
    x, img = inputs
    dpts = {name: (fields, dpt_params[name][1]) for name, (fields, _, _) in DPT_FAMILIES.items()}
    return spawn(spatial_world, 8, "cpu", TINY_FIELDS, v21_params[1], np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
                 small_params[1], img, dpts, dpt_img)


@pytest.fixture(scope="module")
def jax_dpt_estimators(dpt_params):
    """The JAX package's estimators of the two tiny DPTs, registered with the ranks' preprocess."""
    ests, preprocess = {}, JaxPreprocessConfig(**SPATIAL_DPT_PREPROCESS)
    for name, (_, jax_cfg, _) in DPT_FAMILIES.items():
        jreg.register(jreg.ModelEntry(name, lambda cfg=jax_cfg: JaxDPT(cfg), preprocess,
                                      lambda sd, cfg=jax_cfg: convert_dpt(sd, cfg)))
        ests[name] = JaxEstimator(name, params=dpt_params[name][0], verbose=False)
    return ests


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


def _assert_every_rank_holds(world, key, want, atol):
    scale = np.abs(want).max() + 1e-8
    assert scale > 0.1  # a live map, so that the max-scaled comparison means something
    for r in world:
        assert r[key].shape == want.shape and r[key].dtype == np.float32
        np.testing.assert_allclose(r[key] / scale, want / scale, atol=atol)


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("name", list(DPT_FAMILIES))
def test_dpt_predict_spatial_matches_jax_predict(world, jax_dpt_estimators, dpt_img, name, n):
    """The DPT families' frame program, every layer's rows (the patch rows, the
    hybrid's stem rows, the decoder's) over n ranks and the trunk
    sequence-parallel over them, against JAX's ``predict`` (max-scaled 1e-4,
    the hybrid 2e-4), every rank holding the whole map. At 8 ranks the 6
    patch rows leave two ranks empty."""
    want = jax_dpt_estimators[name].predict(dpt_img)
    assert want.shape == (120, 160)
    _assert_every_rank_holds(world, f"{name}_tp{n}", want, DPT_FAMILIES[name][2])


@pytest.mark.parametrize("name", list(DPT_FAMILIES))
def test_dpt_predict_spatial_matches_jax_predict_spatial(world, jax_dpt_estimators, dpt_img, name):
    """The second reference: JAX's own ``predict_spatial`` (GSPMD) on the
    eight-device CPU mesh, against the port's over 8 gloo ranks."""
    mesh8 = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8), axis_names=("dp", "tp"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_dpt_estimators[name].predict_spatial(dpt_img, mesh8, axis="tp")
    _assert_every_rank_holds(world, f"{name}_tp8", want, DPT_FAMILIES[name][2])


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


@pytest.mark.parametrize("n", [1, 3, 5, 13])
@pytest.mark.parametrize("name", list(DPT_FAMILIES))
def test_local_world_runs_the_dpt_families_as_their_forward(dpt_params, name, n):
    """The DPT families' rows in one process (chip_smoke's ``parallel_sp``
    runs them so on the card), the trunk whole, against the unpartitioned
    forward at 64×96 (a 4×6 patch grid: at 13 ranks most own no rows). The
    hybrid runs in float64: its stem's 16 GroupNorm bottlenecks lift the
    rounding of any two f32 orders of summation to the order of 2e-5 of the
    map's largest value, so in f32 the test would hold rounding, not the
    rules."""
    fields = DPT_FAMILIES[name][0]
    dtype = torch.float64 if fields.get("hybrid") else torch.float32
    model = DPT(DPTConfig(**fields))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in dpt_params[name][1].items()})
    model = model.eval().to(dtype)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, 3, 64, 96))).to(dtype)
    with torch.no_grad():
        want = model(x)
        got = spatial_forward(RowWorld.local(n), model, x)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n", [3, 9])
def test_group_norm_takes_its_statistics_over_the_axis(n):
    """GroupNorm of 7 rows cut over 3 ranks, and over 9 (two own none),
    every row with a scale of its own and the mean at 1e6, against
    ``F.group_norm`` of the whole tensor (float64): statistics of a rank's
    rows alone would miss by O(1), and E[x²] − E[x]² would lose the
    variance to cancellation far above the 1e-8 held here."""
    g = torch.Generator().manual_seed(n)
    rows = torch.arange(1, 8, dtype=torch.float64)[:, None]
    x = 1e6 + rows * torch.randn((2, 64, 7, 5), generator=g, dtype=torch.float64)
    m = GroupNormAct(64).double()
    with torch.no_grad():
        m.weight.copy_(torch.randn(64, generator=g, dtype=torch.float64))
        m.bias.copy_(torch.randn(64, generator=g, dtype=torch.float64))
        world = RowWorld.local(n)
        got = world.gather(apply(world, m, world.shard(x, 2)))
        want = F.relu(F.group_norm(x, 32, m.weight, m.bias, m.eps))
    torch.testing.assert_close(got, want, atol=1e-8, rtol=0)


@pytest.mark.parametrize("k", [4, 2])
def test_transposed_conv_fetches_the_input_rows_of_its_output_rows(k):
    """DPT's reassemble resamples (kernel = stride = 4 and 2) over 3 ranks
    of 5 input rows: a rank's output rows [o0, o1) of the 5k, cut anew, come
    from input rows [⌊o0/k⌋, ⌈o1/k⌉)."""
    world = RowWorld.local(3)
    x = torch.randn((2, 4, 5, 6))
    m = nn.ConvTranspose2d(4, 3, k, stride=k)
    fetched = {}
    fetch = world.fetch

    def recording(rows, needs):
        fetched.update(needs)
        return fetch(rows, needs)

    world.fetch = recording
    with torch.no_grad():
        got = world.gather(apply(world, m, world.shard(x, 2)))
        want = m(x)
    bounds = row_bounds(5 * k, 3)
    assert fetched == {r: (o0 // k, -(-o1 // k)) for r, (o0, o1) in enumerate(bounds)}
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_a_module_without_a_row_rule_raises():
    world = RowWorld.local(2)
    x = world.shard(torch.zeros((1, 2, 8, 8)), 2)
    for m in (nn.ConvTranspose2d(2, 2, 3, stride=2), nn.Upsample(scale_factor=2), nn.LayerNorm(8)):
        with pytest.raises(NotImplementedError, match="no row rule"):
            apply(world, m, x)
    with pytest.raises(NotImplementedError, match="Sequential: no spatial program"):
        spatial_forward(world, nn.Sequential(nn.Conv2d(3, 1, 1)), torch.zeros((1, 3, 8, 8)))


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
