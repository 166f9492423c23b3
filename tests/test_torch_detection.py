"""The port's detection-only pipeline against the JAX package's, on the CPU,
with the same weights (``params_from_jax_*``) and the same seeded inputs:
the ROI median samplers, ``FaceDetector``, the detection program
(``make_fused_detection_frame_fn``, ``FusedDetectionRunner``), the
three-tier ``_loop`` of ``depth_by_detection`` against the root script's,
and the port's entry point.

Where the two packages' f32 roundings may part, ints are equal or ±1 where
JAX's float lies within 1e-3 of an integer (the rule of
tests/test_torch_fused.py).
"""

import argparse
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depth_by_detection as root_dbd
from depth_estimation_tpu.detect.face_detector import FaceDetector as JaxFaceDetector
from depth_estimation_tpu.models.facemesh import FaceMeshWithIris as JaxFaceMeshWithIris
from depth_estimation_tpu.ops import sampling as jsamp
from depth_estimation_tpu.runtime import fused as jfused
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu.runtime.video import open_source as jax_open_source
from depth_estimation_tpu_torch import depth_by_detection as dbd
from depth_estimation_tpu_torch.detect.face_detector import FaceDetector
from depth_estimation_tpu_torch.ops import sampling as tsamp
from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner, make_fused_detection_frame_fn
from depth_estimation_tpu_torch.runtime.video import NullSink, open_source
from depth_estimation_tpu_torch.utils.convert import params_from_jax_facemesh
from tests.test_torch_detect import detector_trees, port_params
from tests.test_torch_estimator import _collector
from tests.test_torch_fused import assert_mesh_rule, estimators  # noqa: F401  (a fixture)

H, W = 96, 128
HIT, MISS = 0.0, 2.0  # detection thresholds: every frame detects / none does


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads a worker while this module runs (six workers share the host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trees():
    return detector_trees()


@pytest.fixture(scope="module")
def detectors(trees):
    """(JAX FaceDetector, port FaceDetector) on the same weights, by (threshold, faithful)."""
    cache = {}

    def get(thresh, faithful=True):
        if (thresh, faithful) not in cache:
            cache[thresh, faithful] = (
                JaxFaceDetector(minDetectionCon=thresh, params=trees, faithful=faithful),
                FaceDetector(minDetectionCon=thresh, params=port_params(trees), faithful=faithful, device="cpu"))
        return cache[thresh, faithful]

    return get


@pytest.fixture(scope="module")
def jax_float_mesh():
    """JAX's frame-pixel landmarks before the int cast, through the
    detection program's crop (for the ±1 rule): BGR bytes /255 when
    ``faithful``, else the RGB frame."""
    model = JaxFaceMeshWithIris()

    @functools.partial(jax.jit, static_argnums=3)
    def fn(mesh_params, img_u8, boxes, faithful):
        feed = (img_u8 if faithful else img_u8[..., ::-1]).astype(jnp.float32) / 255.0
        x0, x1, y0, y1 = jfused._crop_box(boxes, img_u8.shape[0], img_u8.shape[1])
        crop = jfused._crop_resize(feed, jnp.stack([x0, y0, x1 - x0, y1 - y0]), (192, 192))
        lm, _ = model.apply(mesh_params, crop[None])
        return jnp.stack([x0 + lm[0, :, 0] * ((x1 - x0) / 192.0), y0 + lm[0, :, 1] * ((y1 - y0) / 192.0)], -1)

    return lambda mesh_params, img, boxes, faithful=True: np.asarray(fn(mesh_params, img, boxes, faithful))


@contextlib.contextmanager
def degenerate_iris(trees, *detector_pairs):
    """The iris head zeroed in both packages' meshes: every iris point of an
    eye lands on one pixel, so each hit's iris fit has radius 0."""
    tree = jax.tree_util.tree_map(np.copy, trees["facemesh"])
    for k in ("kernel", "bias"):
        tree["iris"]["iris_out"][k] = np.zeros_like(tree["iris"]["iris_out"][k])
    saved = [(j._impl._mesh_params, {k: v.clone() for k, v in t._impl._mesh.state_dict().items()})
             for j, t in detector_pairs]
    try:
        for j, t in detector_pairs:
            j._impl._mesh_params = {"params": tree}
            t._impl._mesh.load_state_dict(params_from_jax_facemesh(tree))
        yield
    finally:
        for (j, t), (jp, tsd) in zip(detector_pairs, saved):
            j._impl._mesh_params = jp
            t._impl._mesh.load_state_dict(tsd)


def _frames(rng, n):
    return rng.integers(0, 256, (n, H, W, 3), np.uint8)


# -- the depth samplers ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["odd", "even", "one", "empty", "all"])
def test_masked_median_matches_jax_exactly(rng, case):
    values = rng.standard_normal((7, 9)).astype(np.float32)
    mask = {"odd": rng.random((7, 9)) < 0.4, "even": np.arange(63).reshape(7, 9) < 10,
            "one": np.arange(63).reshape(7, 9) == 17, "empty": np.zeros((7, 9), bool),
            "all": np.ones((7, 9), bool)}[case]
    if case == "odd" and mask.sum() % 2 == 0:
        mask.flat[np.flatnonzero(~mask)[0]] = True
    want = np.asarray(jsamp.masked_median(values, mask))
    got = tsamp.masked_median(torch.from_numpy(values).reshape(-1), torch.from_numpy(mask).reshape(-1)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got) == (case == "empty")


def test_rois_median_depth_matches_jax_exactly(rng):
    """M boxes in one masked sort: inside, at the frame edge (and past it),
    one pixel, empty (ymin == ymax: nan), inverted (nan) and an invalid slot
    (nan), against JAX's vmapped form, bit for bit."""
    depth = (rng.random((H, W)) * 50).astype(np.float32)
    boxes = np.int32([[10, 20, 40, 60], [0, 0, H, W], [80, 100, H + 30, W + 9], [5, 5, 6, 6],
                      [30, 30, 30, 50], [40, 40, 20, 20], [-4, -7, 11, 13], [12, 14, 50, 51]])
    valid = np.array([True, True, True, True, True, True, True, False])
    want = np.asarray(jsamp.rois_median_depth(depth, boxes, valid))
    got = tsamp.rois_median_depth(torch.from_numpy(depth), torch.from_numpy(boxes), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[[4, 5, 7]]).all() and not np.isnan(want[[0, 1, 2, 3, 6]]).any()
    for i in range(4):  # one box alone, and odd/even counts
        one = tsamp.roi_median_depth(torch.from_numpy(depth), torch.from_numpy(boxes[i]))
        np.testing.assert_array_equal(one.numpy(), np.asarray(jsamp.roi_median_depth(depth, boxes[i])))


@pytest.mark.parametrize("faithful", [False, True], ids=["yx", "transposed"])
def test_depth_at_points_and_iris_depth_match_jax(rng, faithful):
    depth = (rng.random((H, W)) * 50).astype(np.float32)
    pts = np.float32([[3.7, 5.2], [127.9, 95.5], [-4.0, 200.0], [60.0, 10.0], [300.5, -2.5]])
    want = np.asarray(jsamp.depth_at_points(depth, pts, faithful=faithful))
    np.testing.assert_array_equal(tsamp.depth_at_points(torch.from_numpy(depth), torch.from_numpy(pts),
                                                        faithful=faithful).numpy(), want)
    want = np.asarray(jsamp.iris_depth(depth, pts[0], pts[1]))
    got = tsamp.iris_depth(torch.from_numpy(depth), torch.from_numpy(pts[0]), torch.from_numpy(pts[1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


# -- FaceDetector ---------------------------------------------------------------------------------


def _bbox_floats(boxes, valid, h, w):
    b = np.asarray(boxes)[np.asarray(valid)]
    return np.stack([b[:, 1] * w, b[:, 0] * h, (b[:, 3] - b[:, 1]) * w, (b[:, 2] - b[:, 0]) * h], -1)


@pytest.mark.parametrize("precomputed", [False, True], ids=["staged", "detection"])
def test_find_faces_matches_jax(detectors, rng, monkeypatch, precomputed):
    """Boxes by the ±1 rule on JAX's float boxes × frame size, scores 1e-5,
    ids and centers from those boxes; with ``detection=`` no net runs."""
    jdet, tdet = detectors(HIT)
    img = _frames(rng, 1)[0]
    jdetection = jdet._impl._detect_fn((H, W), "face")(jdet._impl._face_det_params, img)
    detection = None
    if precomputed:
        detection = tuple(np.asarray(a) for a in jdetection)
    _, want = jdet.findFaces(img.copy(), draw=False, detection=detection)
    if precomputed:
        monkeypatch.setattr(tdet, "_detect", lambda img: pytest.fail("BlazeFace ran with detection= given"))
        _, got = tdet.findFaces(img.copy(), draw=False, detection=detection)
    else:
        drawn = img.copy()
        drawn, got = tdet.findFaces(drawn, draw=True)
        assert (drawn != img).any(), "draw=True draws the boxes"
    assert len(got) == len(want) > 0
    floats = _bbox_floats(jdetection[0], jdetection[2], H, W)
    assert_mesh_rule(np.array([b["bbox"] for b in got]), np.array([b["bbox"] for b in want]), floats)
    for g, w in zip(got, want):
        assert g["id"] == w["id"]
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5, rtol=0)
        assert g["center"] == (g["bbox"][0] + g["bbox"][2] // 2, g["bbox"][1] + g["bbox"][3] // 2)


@pytest.mark.parametrize("faithful", [True, False], ids=["bgr_feed", "rgb_feed"])
def test_find_iris_matches_jax(detectors, jax_float_mesh, rng, faithful):
    """The staged findIris on a hit: ints by the ±1 rule against JAX's,
    fed the BGR bytes when faithful, the RGB frame otherwise; a miss is None."""
    jdet, tdet = detectors(HIT, faithful)
    img = _frames(rng, 1)[0]
    want, got = jdet.findIris(img), tdet.findIris(img)
    assert got.shape == want.shape == (478, 2) and got.dtype == want.dtype
    boxes = np.asarray(jdet._impl._detect_fn((H, W), "face")(jdet._impl._face_det_params, img)[0])
    assert_mesh_rule(got, want, jax_float_mesh(jdet._impl._mesh_params, img, boxes, faithful))
    other = jax_float_mesh(jdet._impl._mesh_params, img, boxes, not faithful)
    with pytest.raises(AssertionError):  # the rule tells the two feeds apart
        assert_mesh_rule(got, other.astype(int), other)
    assert detectors(MISS, faithful)[1].findIris(img) is None


def test_find_body_matches_jax(detectors, rng):
    jdet, tdet = detectors(MISS)
    img = _frames(rng, 1)[0]
    jimg, jpts = jdet.findBody(img.copy())
    timg, tpts = tdet.findBody(img.copy())
    assert np.abs(np.asarray(tpts) - np.asarray(jpts)).max() <= 1
    scale = np.abs(jdet._impl.results["landmarks"]).max()
    np.testing.assert_allclose(tdet._impl.results["landmarks"] / scale, jdet._impl.results["landmarks"] / scale,
                               atol=1e-4)
    img2, pts2 = tdet.body_from_fused(img.copy(), tdet._impl.results["landmarks"], tdet._impl.results["score"])
    np.testing.assert_array_equal(np.asarray(pts2), np.asarray(tpts))
    np.testing.assert_array_equal(img2, timg)


# -- the detection program ----------------------------------------------------------------------


@pytest.mark.parametrize("thresh,faithful", [(HIT, True), (HIT, False), (MISS, True)],
                         ids=["hit_bgr_feed", "hit_rgb_feed", "miss"])
def test_detection_program_matches_jax(detectors, jax_float_mesh, rng, thresh, faithful):
    """Two frames in one program against JAX's program frame by frame:
    boxes and scores 1e-5, valid exact, mesh by the ±1 rule (JAX's zeros on
    a miss), pose max-scaled 1e-4 (JAX's zeros and score 0 on a hit); and
    the batch equal to each frame alone."""
    jdet, tdet = detectors(thresh, faithful)
    imgs = _frames(rng, 2)
    jrun = jfused.FusedDetectionRunner(jdet)
    prog = make_fused_detection_frame_fn(tdet, (H, W))
    batch = {k: v.numpy() for k, v in prog(torch.from_numpy(imgs)).items()}
    for i in range(2):
        boxes, scores, valid, mesh, plm, pscore = jrun(imgs[i])
        got = {k: v[i] for k, v in batch.items()}
        assert bool(valid[0]) == (thresh == HIT)
        np.testing.assert_array_equal(got["valid"], valid)
        np.testing.assert_allclose(got["boxes"], boxes, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["scores"], scores, atol=1e-5, rtol=0)
        assert got["mesh"].dtype == np.int32 and got["mesh"].shape == (478, 2)
        if thresh == HIT:
            assert_mesh_rule(got["mesh"], mesh, jax_float_mesh(jdet._impl._mesh_params, imgs[i], boxes, faithful))
            assert not got["pose_lm"].any() and got["pose_score"] == 0 == pscore and not plm.any()
        else:
            assert not got["mesh"].any() and not mesh.any()
            scale = np.abs(plm).max()
            np.testing.assert_allclose(got["pose_lm"] / scale, plm / scale, atol=1e-4)
            np.testing.assert_allclose(got["pose_score"], pscore, atol=1e-4)
        single = {k: v.numpy()[0] for k, v in prog(torch.from_numpy(imgs[i:i + 1])).items()}
        for key in ("valid", "mesh"):
            np.testing.assert_array_equal(single[key], got[key], err_msg=key)
        for key in ("boxes", "scores", "pose_lm", "pose_score"):
            np.testing.assert_allclose(single[key], got[key], atol=1e-5, rtol=1e-5, err_msg=key)


def test_runner_returns_the_program_outputs_as_numpy(detectors, rng):
    _, tdet = detectors(HIT)
    img = _frames(rng, 1)[0]
    runner = FusedDetectionRunner(tdet)
    got = runner(img)
    want = make_fused_detection_frame_fn(tdet, (H, W))(torch.from_numpy(img[None]))
    names = ("boxes", "scores", "valid", "mesh", "pose_lm", "pose_score")
    assert len(got) == 6 and all(isinstance(g, (np.ndarray, np.generic)) for g in got)
    for g, name in zip(got, names):
        np.testing.assert_array_equal(g, want[name][0].numpy(), err_msg=name)
    runner(img)
    assert len(runner._cache) == 1
    with pytest.raises(ValueError, match="given to the"):
        runner.program((H, W))(torch.from_numpy(_frames(rng, 1)[:, :64]))


# -- the three-tier loop against the root script's ---------------------------------------------


class _Recorder:
    """Wraps a detector: keeps the bboxes each findFaces returned."""

    def __init__(self, det):
        self.det, self.found = det, []

    def __getattr__(self, name):
        return getattr(self.det, name)

    def findFaces(self, img, draw=True, detection=None):
        img, bboxes = self.det.findFaces(img, draw=draw, detection=detection)
        self.found.append(bboxes)
        return img, bboxes


def _run_loop(module, det, runner, estimator, head, open_src, sink, capsys):
    args = argparse.Namespace(quiet=False)
    video, writer, rec = open_src(f"synthetic:4x{H}x{W}"), sink, _Recorder(det)
    head = list(head)
    f = module.f_length(module.in_to_mm(20), w_object=82.6,
                        w_pix=module.dist_euclid((module.CARD[0], module.CARD[2]), (module.CARD[1], module.CARD[3])))
    capsys.readouterr()
    module._loop(args, video, writer, rec, runner, estimator, f, head, None)
    return head, capsys.readouterr().out.splitlines(), len(writer.frames), rec.found


@pytest.mark.parametrize("mode,thresh,tier,with_depth", [
    ("fused", HIT, 1, False), ("staged", HIT, 1, False), ("fused", MISS, 3, False), ("staged", MISS, 3, False),
    ("fused", HIT, 2, True), ("staged", HIT, 2, False)],
    ids=["fused_tier1", "staged_tier1", "fused_tier3", "staged_tier3", "fused_tier2_depth", "staged_tier2"])
def test_loop_matches_the_root_script(detectors, trees, estimators, capsys, mode, thresh, tier,  # noqa: F811
                                      with_depth):
    """4 synthetic frames through the root script's ``_loop`` (JAX) and the
    port's, same weights: the same stdout lines (frame lines, bbox prints,
    the end message), frames written and head measurements (rtol 1e-6).
    Tier 2 needs a hit whose iris fit is degenerate (the iris head zeroed)
    and a head measurement from before (seeded); with ``--with-depth`` each
    box's ROI median depth agrees within 1e-4 of the medians' range (the
    depth maps' own max-scaled 1e-4, a median moving no further than the
    map). Tier 3 with a seeded measurement prints its distance."""
    jdet, tdet = detectors(thresh)
    head = [] if tier == 1 else [150.0]
    runs = []
    degenerate = degenerate_iris(trees, (jdet, tdet)) if tier == 2 else contextlib.nullcontext()
    with degenerate:
        for module, det, runner_cls, est, src, sink in (
                (root_dbd, jdet, jfused.FusedDetectionRunner, estimators[0], jax_open_source,
                 _collector(JaxNullSink)),
                (dbd, tdet, FusedDetectionRunner, estimators[1], open_source, _collector(NullSink))):
            runner = runner_cls(det) if mode == "fused" else None
            runs.append(_run_loop(module, det, runner, est if with_depth else None, head, src, sink, capsys))
    (jhead, jout, jn, jfound), (thead, tout, tn, tfound) = runs
    assert tout == jout
    assert tn == jn == 4
    assert len(thead) == len(jhead) == (4 if tier == 1 else 1)
    np.testing.assert_allclose(thead, jhead, rtol=1e-6)
    assert any(line.startswith("(") for line in tout) == (tier == 2)
    assert [len(b) for b in tfound] == [len(b) for b in jfound]
    if tier == 2:
        assert all(tfound), "tier 2 must have boxes on every frame"
    if with_depth:
        jmeds = np.array([b["roi_median_depth"] for frame in jfound for b in frame])
        tmeds = np.array([b["roi_median_depth"] for frame in tfound for b in frame])
        np.testing.assert_allclose(tmeds, jmeds, atol=1e-4 * np.nanmax(np.abs(jmeds)), rtol=0)


# -- the entry point ----------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--staged"], ["--with-depth", "MiDaS_small", "--trace"]],
                         ids=["fused", "staged", "with_depth_traced"])
def test_entry_point_writes_an_avi(tmp_path, capsys, monkeypatch, extra):
    """``main([..., "--device", "cpu"])`` runs 2 frames at 96×128 to the end
    and writes its .avi (and, traced, a trace into ./torch_trace)."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out.avi"
    dbd.main(["--src", f"synthetic:2x{H}x{W}", "--output", str(out), "--device", "cpu"] + extra)
    text = capsys.readouterr().out
    assert "Frame count: 2.0" in text and "No access to video feed. Exiting..." in text
    assert out.exists() and out.stat().st_size > 0
    if "--trace" in extra:
        assert "Trace written to ./torch_trace" in text
        assert list((tmp_path / "torch_trace").glob("trace_*.json"))


def test_entry_point_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dbd.main(["--src", f"synthetic:1x{H}x{W}", "--output", "unused.avi"])
