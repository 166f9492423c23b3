"""The port's detector stack against the JAX package's, on the CPU, with the
same inputs (numpy, from a seed) and the same weights (``params_from_jax_*``):
anchors, decode and NMS, the circle fit, the crops, the three detector nets,
K2's linear route and the staged ``PersonDetector`` calls."""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.detect import anchors as janc
from depth_estimation_tpu.detect import circle as jcirc
from depth_estimation_tpu.detect.person_detector import PersonDetector as JaxPersonDetector
from depth_estimation_tpu.geometry.face import FaceDet as JaxFaceDet
from depth_estimation_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from depth_estimation_tpu.models.blazepose import BlazePose as JaxBlazePose
from depth_estimation_tpu.models.blazepose import BlazePoseDetector as JaxBlazePoseDetector
from depth_estimation_tpu.models.facemesh import FaceMeshWithIris as JaxFaceMeshWithIris
from depth_estimation_tpu.ops.pallas.resize import pallas_preprocess
from depth_estimation_tpu.ops.resize import resize2d as jax_resize2d
from depth_estimation_tpu.ops.sampling import crop_resize_bilinear as jax_crop
from depth_estimation_tpu.ops.sampling import crop_resize_bilinear_rect as jax_crop_rect
from depth_estimation_tpu.ops.sampling import crop_resize_linear_matmul as jax_crop_matmul
from depth_estimation_tpu_torch.config import CARD
from depth_estimation_tpu_torch.detect import anchors as tanc
from depth_estimation_tpu_torch.detect import circle as tcirc
from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
from depth_estimation_tpu_torch.geometry.face import FaceDet
from depth_estimation_tpu_torch.models.blazeface import BlazeFace
from depth_estimation_tpu_torch.models.blazepose import BlazePose, BlazePoseDetector
from depth_estimation_tpu_torch.models.facemesh import FaceMeshWithIris
from depth_estimation_tpu_torch.ops.kernels import resize as trsz
from depth_estimation_tpu_torch.ops.sampling import bgr_u8_to_rgb01, crop_resize_bilinear, crop_resize_bilinear_rect
from depth_estimation_tpu_torch.utils import convert

CLASSIFIER_SCALE = 0.05  # scores near 0.75, not saturated
BOX_SIZE = 0.2
# (params key of both detectors, JAX module, input size, port module, converter)
NETS = {
    "blazeface": (JaxBlazeFace, 128, BlazeFace, convert.params_from_jax_blazeface),
    "facemesh": (JaxFaceMeshWithIris, 192, FaceMeshWithIris, convert.params_from_jax_facemesh),
    "blazepose": (JaxBlazePose, 256, BlazePose, convert.params_from_jax_blazepose),
    "blazepose_detector": (JaxBlazePoseDetector, 224, BlazePoseDetector, convert.params_from_jax_blazepose_detector),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The CPU suite runs six workers on one host, each torch process with a
    thread a core by default: two intra-op threads a worker while this
    module runs keep them from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_flax_tree(module, size, seed, blazeface=False):
    """A Flax param tree of ``module`` with numpy leaves, structure from
    ``jax.eval_shape`` (no compile): kernels ~ N(0, 1/fan_in), biases ~
    N(0, 0.02²), PReLU alphas 0.25, the port's random weights' rule.
    With ``blazeface``, its box regressors are scaled ×3 and their width and height
    biased to ``BOX_SIZE`` of the frame, so that boxes have an area and face
    crops span some 20-30% of the frame; its classifiers are scaled by
    ``CLASSIFIER_SCALE``, so that scores do not saturate."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel":
            v = rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1]))
            if blazeface and any(n.startswith("regressor_") for n in names):
                v = v * 3.0
            elif blazeface and any(n.startswith("classifier_") for n in names):
                v = v * CLASSIFIER_SCALE
        elif names[-1] == "alpha":
            v = np.full(s.shape, 0.25)
        else:
            v = 0.02 * rng.standard_normal(s.shape)
            if blazeface and any(n.startswith("regressor_") for n in names):
                v = v.reshape(-1, 16)
                v[:, 2:4] += BOX_SIZE * 128  # positive widths and heights
        return v.astype(np.float32).reshape(s.shape)

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def detector_trees(seed=0):
    """Flax trees of the JAX PersonDetector's four nets, from ``seed``."""
    return {key: random_flax_tree(jmod(), size, seed + i, key == "blazeface")
            for i, (key, (jmod, size, _, _)) in enumerate(NETS.items())}


def port_params(trees):
    """The same weights as the port's PersonDetector takes them."""
    return {key: NETS[key][3](tree) for key, tree in trees.items() if NETS[key][3] is not None}


def detector_pair(trees, thresh, device="cpu"):
    """(JAX PersonDetector, port PersonDetector), each with its own FaceDet,
    on the same weights."""
    jdet = JaxPersonDetector(JaxFaceDet(20, CARD), minDetectionCon=thresh, params=trees)
    tdet = PersonDetector(FaceDet(20, CARD), minDetectionCon=thresh, params=port_params(trees), device=device)
    return jdet, tdet


@pytest.fixture(scope="module")
def trees():
    return detector_trees()


def _max_scaled(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


# -- anchors, decode, NMS -------------------------------------------------------


def test_anchors_exact():
    assert tanc.BLAZEFACE_FRONT == tanc.AnchorConfig() and tanc.BLAZEFACE_FRONT.heads == janc.BLAZEFACE_FRONT.heads
    got, want = tanc.build_anchors(tanc.BLAZEFACE_FRONT), janc.build_anchors(janc.BLAZEFACE_FRONT)
    assert got.shape == (896, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_matches_jax(rng):
    raw = (rng.standard_normal((2, 896, 16)) * 20).astype(np.float32)
    logits = (rng.standard_normal((2, 896)) * 60).astype(np.float32)
    anchors = janc.build_anchors(janc.BLAZEFACE_FRONT)
    want_b = np.asarray(janc.decode_boxes(raw, anchors, 128.0))
    got_b = tanc.decode_boxes(torch.from_numpy(raw), torch.from_numpy(anchors), 128.0)
    np.testing.assert_allclose(got_b.numpy(), want_b, atol=1e-6, rtol=0)
    want_s = np.asarray(janc.decode_scores(logits))
    np.testing.assert_allclose(tanc.decode_scores(torch.from_numpy(logits)).numpy(), want_s, atol=1e-6, rtol=0)


def _candidates(rng, kind):
    """896 candidate boxes and scores: overlapping clusters, and with
    ``ties`` many equal scores (saturated sigmoids, as random nets give)."""
    centers = rng.random((6, 2)) * 0.8 + 0.1
    c = centers[rng.integers(0, 6, 896)] + rng.normal(0, 0.02, (896, 2))
    size = rng.uniform(0.05, 0.2, (896, 2))
    boxes = np.concatenate([c - size / 2, c + size / 2, rng.random((896, 12))], axis=1)[:, [1, 0, 3, 2, *range(4, 16)]]
    scores = rng.random(896)
    if kind == "ties":
        scores = np.where(scores > 0.5, 1.0, np.round(scores, 1))
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("kind,thresh", [("random", 0.5), ("ties", 0.5), ("ties", 0.0), ("random", 2.0)],
                         ids=["random", "ties", "ties_all_candidates", "none_valid"])
@pytest.mark.parametrize("weighted", [False, True], ids=["hard", "weighted"])
def test_nms_matches_jax(rng, kind, thresh, weighted):
    """Equal ``valid`` and order (equal scores by anchor index: the stable
    sort), boxes and scores within 1e-6."""
    boxes, scores = _candidates(rng, kind)
    jfn, tfn = (janc.weighted_nms, tanc.weighted_nms) if weighted else (janc.nms, tanc.nms)
    wb, ws, wv = (np.asarray(v) for v in jfn(boxes, scores, 0.3, thresh))
    gb, gs, gv = tfn(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, thresh)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_allclose(gs.numpy(), ws, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gb.numpy(), wb, atol=1e-6, rtol=0)
    if kind == "ties" and thresh == 0.5:
        assert (ws[wv] == 1.0).sum() > 1, "the case must keep tied scores"


def test_nms_batched_equals_each_row(rng):
    rows = [_candidates(rng, "ties") for _ in range(3)]
    boxes = torch.from_numpy(np.stack([b for b, _ in rows]))
    scores = torch.from_numpy(np.stack([s for _, s in rows]))
    batched = tanc.weighted_nms(boxes, scores, 0.3, 0.2)
    for i in range(3):
        (gb, gs, gv), (wb, ws, wv) = (t[i] for t in batched), tanc.weighted_nms(boxes[i], scores[i], 0.3, 0.2)
        torch.testing.assert_close(gv, wv, rtol=0, atol=0)
        torch.testing.assert_close(gs, ws, rtol=0, atol=0)
        torch.testing.assert_close(gb, wb, rtol=0, atol=1e-6)  # the blend's matmul may sum in another order


# -- circle fit -------------------------------------------------------------------


def _point_sets(rng):
    sets = [rng.integers(0, 40, (4, 2)).astype(np.float32) for _ in range(40)]  # mesh ints
    sets += [(rng.random((4, 2)) * 100).astype(np.float32) for _ in range(20)]
    sets += [np.float32([[0, 0], [1, 1], [2, 2], [3, 3]]),  # collinear: degenerate triples
             np.float32([[5, 5], [5, 5], [5, 5], [5, 5]]),  # one point: radius 0
             np.float32([[0, 0], [4, 0], [0, 4], [4, 4]])]  # on one circle: equal radii
    return np.stack(sets)


def test_min_enclosing_circle_numpy_copy_matches_jax(rng):
    for pts in _point_sets(rng):
        assert tcirc.min_enclosing_circle(pts) == jcirc.min_enclosing_circle(pts)


def test_min_enclosing_circle_device_form_matches_jax(rng):
    """Batched over point sets, against JAX's vmapped device form: centers
    and radii within 1e-4·r (1e-4 where r < 1)."""
    sets = _point_sets(rng)
    wc, wr = (np.asarray(v) for v in jax.vmap(jcirc.min_enclosing_circle_jax)(sets))
    gc, gr = tcirc.min_enclosing_circle_torch(torch.from_numpy(sets))
    tol = 1e-4 * np.maximum(wr, 1.0)
    assert (np.abs(gr.numpy() - wr) <= tol).all()
    assert (np.abs(gc.numpy() - wc).max(axis=1) <= tol).all()
    # and the host solver's answer within the same slack
    for pts, c, r in zip(sets, gc.numpy(), gr.numpy()):
        (hc, hr) = tcirc.min_enclosing_circle(pts)
        assert abs(r - hr) <= 1e-4 * max(hr, 1.0) and np.abs(c - hc).max() <= 1e-4 * max(hr, 1.0)


# -- crops --------------------------------------------------------------------------

_RECTS = [(3, 5, 40, 32), (0, 0, 160, 120), (159, 119, 1, 1), (0, 0, 1, 1), (150, 100, 10, 20), (60, 40, 17, 11)]


def test_crop_resize_rect_matches_both_jax_forms(rng):
    """Batched over boxes (at the border, of one pixel) against JAX's gather
    and matmul forms, at 1e-5; and the u8 BGR frame sampled through
    ``bgr_u8_to_rgb01`` as JAX samples its /255 RGB frame."""
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    rgb01 = img[..., ::-1].astype(np.float32) / 255.0
    boxes = np.float32(_RECTS)
    got = crop_resize_bilinear_rect(torch.from_numpy(np.stack([rgb01] * len(boxes))), torch.from_numpy(boxes),
                                    (24, 24))
    got_u8 = crop_resize_bilinear_rect(torch.from_numpy(np.stack([img] * len(boxes))), torch.from_numpy(boxes),
                                       (24, 24), pixels=bgr_u8_to_rgb01)
    torch.testing.assert_close(got_u8, got, rtol=0, atol=0)
    for i, box in enumerate(boxes):
        for fn in (jax_crop_rect, jax_crop_matmul):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(fn(rgb01, box, (24, 24))), atol=1e-5, rtol=0)


def test_crop_resize_square_matches_jax(rng):
    img = rng.random((192, 192, 3), dtype=np.float32)
    boxes = np.float32([(10.3, 20.7, 30.1), (0, 0, 192), (180.5, 170.25, 8.0), (-3.0, -2.0, 12.0), (150, 150, 60)])
    got = crop_resize_bilinear(torch.from_numpy(np.stack([img] * len(boxes))), torch.from_numpy(boxes), (64, 64))
    for i, box in enumerate(boxes):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(jax_crop(img, box, (64, 64))), atol=1e-5, rtol=0)


# -- detector nets --------------------------------------------------------------------


@pytest.mark.parametrize("key", ["blazeface", "facemesh", "blazepose", "blazepose_detector"])
def test_detector_net_matches_jax(trees, rng, key):
    """Each net on the same weights and a batch of 2, max-scaled 1e-4."""
    jmod, size, tmod, conv = NETS[key]
    x = rng.random((2, size, size, 3), dtype=np.float32)
    want = jax.jit(jmod().apply)({"params": trees[key]}, x)
    net = tmod()
    net.load_state_dict(conv(trees[key]))  # strict: every key converted, none left over
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for g, w in zip(got, want):
        _max_scaled(g.numpy(), w)


def test_blazepose_full_outputs_match_jax(trees, rng):
    """``return_full``: the raw 39 landmarks, the heatmap branch and the world landmarks."""
    x = rng.random((1, 256, 256, 3), dtype=np.float32)
    _, _, want = jax.jit(lambda p, v: JaxBlazePose().apply(p, v, return_full=True))({"params": trees["blazepose"]}, x)
    net = BlazePose()
    net.load_state_dict(convert.params_from_jax_blazepose(trees["blazepose"]))
    with torch.no_grad():
        _, _, got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), return_full=True)
    assert set(got) == set(want)
    for key in want:
        _max_scaled(got[key].numpy(), want[key])


def test_converters_map_depthwise_and_dense_layouts(trees):
    sd = convert.params_from_jax_blazepose(trees["blazepose"])
    dw = trees["blazepose"]["b128_0"]["conv_dw"]["kernel"]  # (3, 3, 1, 16)
    assert tuple(sd["b128_0.conv_dw.weight"].shape) == (16, 1, 3, 3)
    np.testing.assert_array_equal(sd["b128_0.conv_dw.weight"][:, 0].numpy(), np.transpose(dw[:, :, 0], (2, 0, 1)))
    np.testing.assert_array_equal(sd["ld_3d.weight"].numpy(), trees["blazepose"]["ld_3d"]["kernel"].T)
    np.testing.assert_array_equal(sd["stem_act.alpha"].numpy(), trees["blazepose"]["stem_act"]["alpha"])


# -- K2's linear route -------------------------------------------------------------------


@pytest.mark.parametrize("out_hw,mean,std,jax_input", [
    ((128, 128), (0.5,) * 3, (0.5,) * 3, lambda rgb: rgb * 2.0 - 1.0),
    ((256, 256), (0.0,) * 3, (1.0,) * 3, lambda rgb: rgb)], ids=["blazeface", "blazepose"])
def test_k2_linear_matches_pallas_and_the_fused_xla_form(rng, out_hw, mean, std, jax_input):
    """The plain version of K2's linear route against JAX's Pallas kernel in
    linear mode and against the XLA form of the JAX fused program
    (``resize2d(rgb01·2 − 1)`` for BlazeFace, ``resize2d(rgb01)`` for
    BlazePose), at 1e-5; the wrapper takes it for a CPU tensor."""
    img = rng.integers(0, 256, (2, 480, 640, 3), np.uint8)
    got = trsz.preprocess_plain(torch.from_numpy(img), out_hw, mean, std, method="linear")
    assert got.shape == (2, 3, *out_hw)
    nhwc = got.permute(0, 2, 3, 1).numpy()
    for i in range(2):
        pallas = np.asarray(pallas_preprocess(img[i], out_hw, mean, std, method="linear", interpret=True))[0]
        np.testing.assert_allclose(nhwc[i], pallas, atol=1e-5, rtol=0)
        rgb01 = img[i][..., ::-1].astype(np.float32) / 255.0
        xla = np.asarray(jax_resize2d(jax_input(rgb01), out_hw, method="linear", align_corners=False))
        np.testing.assert_allclose(nhwc[i], xla, atol=1e-5, rtol=0)
    before = trsz.fused_preprocess.launches
    wrapped = trsz.fused_preprocess(torch.from_numpy(img), out_hw, mean, std, method="linear")
    assert trsz.fused_preprocess.launches == before
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_k2_wrapper_refuses_other_devices_and_methods():
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cubic or linear"):
        trsz.fused_preprocess(x, (4, 4), (0.5,) * 3, (0.5,) * 3, method="nearest")
    with pytest.raises(ValueError, match="no preprocess kernel"):
        trsz.fused_preprocess(x, (4, 4), (0.5,) * 3, (0.5,) * 3, method="linear")


# -- PersonDetector: the staged calls ---------------------------------------------------------


@pytest.fixture(scope="module")
def detectors(trees):
    return detector_pair(trees, thresh=0.2)


def test_find_iris_matches_jax(detectors, rng):
    """findIris on one frame (detection, the face crop, the mesh, host
    circles) against JAX's: the same face state, mesh ints within ±1 where
    JAX's float landmark lies within 1e-3 of an integer."""
    jdet, tdet = detectors
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    jdet.face.mesh = tdet.face.mesh = None
    jdet.findIris(img)
    tdet.findIris(img)
    assert jdet.face.mesh is not None and tdet.face.mesh is not None, "threshold 0.2 must detect on random nets"
    assert np.abs(tdet.face.mesh - jdet.face.mesh).max() <= 1
    assert (tdet.face.mesh == jdet.face.mesh).mean() > 0.99
    if (tdet.face.mesh[tdet.LEFT_IRIS] == jdet.face.mesh[jdet.LEFT_IRIS]).all():
        np.testing.assert_allclose(tdet.face.l_iris["radius"], jdet.face.l_iris["radius"], rtol=1e-12)
    assert tdet.results["score"] == pytest.approx(jdet.results["score"], rel=1e-4, abs=1e-6)


def test_find_body_matches_jax(detectors, rng):
    jdet, tdet = detectors
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    jimg, jpts = jdet.findBody(img.copy())
    timg, tpts = tdet.findBody(img.copy())
    _max_scaled(tdet.results["landmarks"], jdet.results["landmarks"])
    assert np.abs(np.asarray(tpts) - np.asarray(jpts)).max() <= 1
    # body_from_fused is findBody's host half
    img2, pts2 = tdet.body_from_fused(img.copy(), tdet.results["landmarks"], tdet.results["score"])
    np.testing.assert_array_equal(np.asarray(pts2), np.asarray(tpts))
    np.testing.assert_array_equal(img2, timg)


def test_find_iris_miss_leaves_face_state(trees, rng):
    _, tdet = detector_pair(trees, thresh=2.0)
    tdet.face.mesh = None
    tdet.findIris(rng.integers(0, 256, (120, 160, 3), np.uint8))
    assert tdet.face.mesh is None and tdet.results is None


def test_visualize_draws_on_the_frame(detectors, rng):
    _, tdet = detectors
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    tdet.face.mesh = None
    tdet.findIris(img)
    frame = img.copy()
    tdet.visualize(frame)
    assert tdet.frame is frame and (frame != img).any()


def test_random_detector_weights_warn_and_are_seeded(tmp_path, monkeypatch):
    monkeypatch.setenv("DEPTH_ESTIMATION_TPU_TORCH_CACHE", str(tmp_path))  # no staged .tflite file
    with pytest.warns(UserWarning, match="random"):
        a = PersonDetector(FaceDet(20, CARD), seed=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = PersonDetector(FaceDet(20, CARD), seed=1, device="cpu")
    for na, nb in ((a._face_det, b._face_det), (a._mesh, b._mesh), (a._pose_det, b._pose_det), (a._pose, b._pose)):
        for (ka, va), (kb, vb) in zip(na.state_dict().items(), nb.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    assert torch.equal(a._pose.stem_act.alpha, torch.full((16,), 0.25))


def test_detector_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PersonDetector(FaceDet(20, CARD), params={})
