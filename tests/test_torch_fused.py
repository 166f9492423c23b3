"""The port's fused iris/pose + depth program and ``FusedVidStream`` against
the JAX package's (``make_fused_iris_frame_fn(include_pose=True)``, JAX
``FusedVidStream``) on the CPU, with the same weights: a tiny DPT registered
in both registries and the detector nets through ``params_from_jax_*``.

Where the two packages' f32 roundings may part, the rules are:
* mesh ints are equal, or ±1 where JAX's float landmark lies within 1e-3 of
  an integer (asserted and counted);
* u8 bytes are equal, or differ where the f32 map lies within 1e-3 of an
  integer (the rule of tests/test_torch_estimator.py).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import DPT_PREPROCESS as JAX_DPT_PREPROCESS
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.runtime import fused as jfused
from depth_estimation_tpu.runtime.stream import FusedVidStream as JaxFusedVidStream
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import CARD, DPT_PREPROCESS, LEFT_IRIS, RIGHT_IRIS
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.geometry.face import FaceDet
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.ops.postprocess import to_video_frame
from depth_estimation_tpu_torch.runtime.fused import FusedFrameRunner, make_fused_iris_frame_fn
from depth_estimation_tpu_torch.runtime.stream import FusedVidStream
from depth_estimation_tpu_torch.runtime.video import NullSink
from depth_estimation_tpu_torch.utils.convert import params_from_jax
from tests.oracles import dpt_torch as oracle
from tests.test_torch_detect import detector_pair, detector_trees
from tests.test_torch_dpt import JAX_TINY, TINY
from tests.test_torch_estimator import _assert_u8_agrees, _collector

NAME = "DPT_Tiny_fused_port_test"
H, W = 120, 160
HIT, MISS = 0.0, 2.0  # detection thresholds: every frame detects / none does
# synthetic:8x120x160's top BlazeFace scores on the test weights run from
# 0.7726 down to 0.7533: frames 1-4 detect, 5-8 do not, each 1e-3 or more
# from the threshold
MIXED = 0.76
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The CPU suite runs six workers on one host, each torch process with a
    thread a core by default: two intra-op threads a worker while this
    module runs keep them from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def estimators():
    jreg.register(jreg.ModelEntry(NAME, lambda: JaxDPT(JAX_TINY), JAX_DPT_PREPROCESS,
                                  lambda sd: convert_dpt(sd, JAX_TINY)))
    treg.register(treg.ModelEntry(NAME, lambda: DPT(TINY), DPT_PREPROCESS))
    hub_sd = {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY, seed=3).items()}
    for k in ("scratch.output_conv.4.weight", "scratch.output_conv.4.bias"):  # depth up to ~80
        hub_sd[k] = hub_sd[k] * 50
    jax_params = convert_dpt(hub_sd, JAX_TINY)
    ref = JaxEstimator(NAME, params=jax_params, verbose=False)
    port = DepthEstimator(NAME, params=params_from_jax(jax_params, TINY), verbose=False, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def trees():
    return detector_trees()


class _Pair:
    """One threshold's JAX program and detector beside the port's."""

    def __init__(self, estimators, trees, thresh):
        self.ref, self.port = estimators
        self.jdet, self.tdet = detector_pair(trees, thresh)
        self.jfn = jfused.make_fused_iris_frame_fn(self.ref, self.jdet, (H, W), include_pose=True)
        self.tfn = make_fused_iris_frame_fn(self.port, self.tdet, (H, W))

    def jax(self, img, pts):
        d = self.jdet
        return jax.device_get(self.jfn(self.ref.params, d._face_det_params, d._mesh_params, d._pose_params,
                                       img, pts))

    def port_batch(self, imgs, pts):
        out = self.tfn(torch.from_numpy(imgs), torch.from_numpy(pts))
        return [{k: v[i].numpy() for k, v in out.items()} for i in range(len(imgs))]


@pytest.fixture(scope="module")
def pairs(estimators, trees):
    return {thresh: _Pair(estimators, trees, thresh) for thresh in (HIT, MISS)}


def jax_float_mesh_fn(jdet, h=H, w=W):
    """fn(img, boxes): JAX's frame-pixel landmarks before the int cast (for
    the ±1 rule), from ``jdet``'s mesh on the crop of ``boxes``' best box."""

    @jax.jit
    def fn(mesh_params, img_u8, boxes):
        rgb = img_u8[..., ::-1].astype(jnp.float32) / 255.0
        x0, x1, y0, y1 = jfused._crop_box(boxes, h, w)
        crop = jfused._crop_resize(rgb, jnp.stack([x0, y0, x1 - x0, y1 - y0]), (192, 192))
        lm, _ = jdet._mesh.apply(mesh_params, crop[None])
        return jnp.stack([x0 + lm[0, :, 0] * ((x1 - x0) / 192.0), y0 + lm[0, :, 1] * ((y1 - y0) / 192.0)], -1)

    return lambda img, boxes: np.asarray(fn(jdet._mesh_params, img, boxes))


@pytest.fixture(scope="module")
def jax_float_mesh(pairs):
    """JAX's frame-pixel landmarks before the int cast (for the ±1 rule)."""
    return jax_float_mesh_fn(pairs[HIT].jdet)


def _max_scaled(got, want, tol=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, err_msg=what)


def assert_mesh_rule(got, want, want_float):
    """Equal ints, or ±1 where JAX's float lies within 1e-3 of an integer.
    Returns how many entries the rule let through."""
    got, want = np.asarray(got), np.asarray(want)
    differ = got != want
    near_int = np.abs(want_float - np.round(want_float)) < 1e-3
    assert not (differ & ~near_int).any(), f"{int((differ & ~near_int).sum())} mesh ints differ away from an integer"
    assert np.abs(got - want).max(initial=0) <= 1
    return int(differ.sum())


def assert_frame_agrees(got, want, want_float_mesh=None):
    """One frame's port outputs against JAX's. Returns the count of mesh
    entries that the ±1 rule let through."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5, rtol=0)
    _max_scaled(got["depth"], want["depth"], what="depth")
    _max_scaled(got["pose_lm"], want["pose_lm"], what="pose_lm")
    np.testing.assert_allclose(got["pose_score"], want["pose_score"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["mesh_score"], want["mesh_score"], atol=1e-5, rtol=0)
    _assert_u8_agrees(got["vis_u8"], want["vis_u8"], want["depth"])
    loose = 0
    if want["valid"][0]:
        loose = assert_mesh_rule(got["mesh"], want["mesh"], want_float_mesh)
    else:
        np.testing.assert_array_equal(got["mesh"], want["mesh"])
    for side, idx in (("l", list(LEFT_IRIS)), ("r", list(RIGHT_IRIS))):
        # circles at 1e-3 on equal iris points; a point the ±1 rule moved moves its circle up to 1
        tol = 1e-3 if (got["mesh"][idx] == want["mesh"][idx]).all() else 1.0 + 1e-3
        np.testing.assert_allclose(got[f"{side}_center"], want[f"{side}_center"], atol=tol, rtol=0)
        np.testing.assert_allclose(got[f"{side}_radius"], want[f"{side}_radius"], atol=tol, rtol=0)
    for key in ("iris_sample", "fallback_sample", "ears_sample"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6 * np.abs(want["depth"]).max(),
                                   err_msg=key)
    return loose


def _frames(rng, n):
    return rng.integers(0, 256, (n, H, W, 3), np.uint8)


def _pts(rng, n):
    """Stored head points, some out of range both ways (the index quirk)."""
    return np.stack([np.int32([[17, 23], [95, 110]]), np.int32([[-5, 300], [-250, -17]])] * n)[:n]


@pytest.mark.parametrize("thresh", [HIT, MISS], ids=["hit", "miss"])
def test_fused_program_matches_jax(pairs, jax_float_mesh, rng, thresh):
    """On a forced hit and a forced miss, frame by frame: depth and pose
    max-scaled 1e-4, boxes and scores 1e-5, valid exact, mesh by the ±1
    rule, circles 1e-3, samples rtol 1e-5, vis_u8 by the u8 rule."""
    pair = pairs[thresh]
    imgs, pts = _frames(rng, 2), _pts(rng, 2)
    got = pair.port_batch(imgs, pts)
    loose = 0
    for i in range(2):
        want = pair.jax(imgs[i], pts[i])
        assert bool(want["valid"][0]) == (thresh == HIT)
        flt = jax_float_mesh(imgs[i], want["boxes"]) if thresh == HIT else None
        loose += assert_frame_agrees(got[i], want, flt)
        if thresh == HIT:  # the hit branch's pose is JAX's zeros, the miss branch's mesh
            assert not got[i]["pose_lm"].any() and got[i]["pose_score"] == 0
            assert got[i]["l_radius"] > 0 and got[i]["mesh"].any()
        else:
            assert not got[i]["mesh"].any() and got[i]["l_radius"] == 0 and got[i]["pose_lm"].any()
    print(f"mesh entries let through by the +-1 rule: {loose}")


def test_batched_matches_per_frame(pairs, rng):
    """K = 2 in one program against two programs of one frame each (a
    batch's convs may round otherwise: floats max-scaled 1e-4)."""
    pair = pairs[HIT]
    imgs, pts = _frames(rng, 2), _pts(rng, 2)
    batched = pair.port_batch(imgs, pts)
    for i in range(2):
        single = pair.port_batch(imgs[i:i + 1], pts[i:i + 1])[0]
        for key, want in single.items():
            if key in ("mesh", "valid"):
                np.testing.assert_array_equal(batched[i][key], want, err_msg=key)
            elif key == "vis_u8":
                _assert_u8_agrees(batched[i][key], want, single["depth"])
            else:
                _max_scaled(batched[i][key], want, what=key)


def test_runner_call_and_batched_are_one_program(pairs, rng):
    pair = pairs[HIT]
    runner = FusedFrameRunner(pair.port, pair.tdet)
    img = _frames(rng, 1)
    one = runner(img[0], fallback_pts=np.int32([[3, 4], [5, 6]]))
    same = runner.batched(img, fallback_pts=np.int32([[[3, 4], [5, 6]]]))
    many = runner.batched(np.concatenate([img, img]))
    assert set(one) == set(same) == set(many) and len(runner._cache) == 1
    for key in one:
        assert one[key].shape == same[key].shape[1:] == many[key].shape[1:]
        torch.testing.assert_close(one[key], same[key][0], rtol=0, atol=0)


def test_runner_without_mesh_matches_jax(pairs, rng):
    """``mesh=False``: depth plus BlazeFace in one program, one frame's
    (depth, boxes, scores, valid) against JAX's; its ``batched`` raises, as
    JAX's does."""
    pair = pairs[HIT]
    img = _frames(rng, 1)[0]
    runner = FusedFrameRunner(pair.port, pair.tdet, mesh=False)
    assert not runner.pose
    got = [t.numpy() for t in runner(img)]
    want = [np.asarray(t) for t in jfused.FusedFrameRunner(pair.ref, pair.jdet, mesh=False)(img)]
    assert [g.shape for g in got] == [w.shape for w in want] == [(H, W), (16, 16), (16,), (16,)]
    _max_scaled(got[0], want[0], what="depth")
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])
    with pytest.raises(ValueError, match="mesh=True"):
        runner.batched(img[None])


@pytest.mark.parametrize("thresh,options", [(HIT, {"pose": False}), (MISS, {"pose": False}),
                                            (MISS, {"emit_depth_map": False})],
                         ids=["no_pose_hit", "no_pose_miss", "no_depth_map_miss"])
def test_runner_options_match_jax(pairs, jax_float_mesh, rng, thresh, options):
    """``pose=False`` (no pose keys; a miss returns the mesh zeros only) and
    ``emit_depth_map=False`` (no ``depth``): the same keys as JAX's runner
    with the same options, each frame of a K = 2 batch agreeing with JAX's
    by ``assert_frame_agrees`` (the depth map, where the program drops it,
    from the runners without the option)."""
    pair = pairs[thresh]
    imgs, pts = _frames(rng, 2), _pts(rng, 2)
    got = FusedFrameRunner(pair.port, pair.tdet, **options).batched(imgs, pts)
    want = jax.device_get(jfused.FusedFrameRunner(pair.ref, pair.jdet, **options).batched(imgs, pts))
    assert set(got) == set(want)
    dropped = {"pose_lm", "pose_score", "ears_sample"} if "pose" in options else {"depth"}
    assert not dropped & set(got) and len(got) == 16 - len(dropped)
    full = FusedFrameRunner(pair.port, pair.tdet).batched(imgs, pts)
    jfull = jax.device_get(jfused.FusedFrameRunner(pair.ref, pair.jdet).batched(imgs, pts))
    for i in range(2):
        g = {k: full[k][i].numpy() if k in dropped else v[i].numpy() for k, v in {**full, **got}.items()}
        w = {k: np.asarray(jfull[k][i] if k in dropped else v[i]) for k, v in {**jfull, **want}.items()}
        flt = jax_float_mesh(imgs[i], w["boxes"]) if thresh == HIT else None
        assert_frame_agrees(g, w, flt)
        if "pose" in options and thresh == MISS:
            assert not got["mesh"][i].any() and got["l_radius"][i] == 0


def test_vis_u8_and_samples_match_the_host_forms(pairs, rng):
    """vis_u8 is to_video_frame of the f32 map, byte for byte; the samples
    are FaceDet.get_depth's on the same map."""
    out = pairs[HIT].port_batch(_frames(rng, 1), _pts(rng, 1))[0]
    np.testing.assert_array_equal(out["vis_u8"], to_video_frame(out["depth"])[..., 0])
    face = FaceDet(20, CARD)
    face.mesh = out["mesh"]
    face.l_iris = {"center": tuple(map(float, out["l_center"])), "radius": float(out["l_radius"])}
    face.r_iris = {"center": tuple(map(float, out["r_center"])), "radius": float(out["r_radius"])}
    face.get_depth(out["depth"])
    np.testing.assert_allclose(out["iris_sample"], face.ri_depth, rtol=1e-6)
    face.mesh, face.head_pts = None, ((17, 23), (95, 110))
    face.get_depth(out["depth"])
    np.testing.assert_allclose(out["fallback_sample"], face.ri_depth, rtol=1e-6)


# -- FusedVidStream ---------------------------------------------------------------------


def _stream_pair(estimators, trees, thresh, **kw):
    """Run JAX's and the port's FusedVidStream on synthetic:8x120x160;
    return each one's (face, frames written, routes taken)."""
    ref, port = estimators
    jdet, tdet = detector_pair(trees, thresh)
    runs = []
    for cls, sink, est, det in ((JaxFusedVidStream, _collector(JaxNullSink), ref, jdet),
                                (FusedVidStream, _collector(NullSink), port, tdet)):
        vs = cls(est, det, det.face, "synthetic:8x120x160", sink, verbose=False, **kw)
        routes = []
        for name in ("_iris_path", "_body_path"):
            orig = getattr(vs, name)
            setattr(vs, name, lambda vis, orig=orig, name=name: (routes.append(name), orig(vis))[1])
        vs.stream()
        runs.append((det.face, sink.frames, routes))
    return runs


@pytest.mark.parametrize("thresh,kw", [(HIT, {"pipeline_depth": 1}), (MIXED, {"pipeline_depth": 2}),
                                       (MIXED, {"microbatch": 2})],
                         ids=["hit_depth1", "mixed_depth2", "mixed_microbatch2"])
def test_fused_vidstream_matches_jax(estimators, trees, thresh, kw):
    """The same depth samples and distances, the same route each frame, and
    the same written frames (byte for byte; the u8 rule and the ±1 rule may
    move a few pixels of a frame, counted)."""
    (jface, jframes, jroutes), (tface, tframes, troutes) = _stream_pair(estimators, trees, thresh, **kw)
    assert troutes == jroutes and len(troutes) == 8
    if thresh == MIXED:
        assert set(troutes) == {"_iris_path", "_body_path"}, "the mixed threshold must take both routes"
    for key in ("ri_depths", "abs_depths", "s2c_ds", "head_measurements"):
        np.testing.assert_allclose(getattr(tface, key), getattr(jface, key), rtol=1e-5, err_msg=key)
    assert len(tframes) == len(jframes) == 8
    moved = []
    for g, w in zip(tframes, jframes):
        assert g.shape == w.shape == (H // 2, W, 3)
        moved.append(int((g != w).any(axis=-1).sum()))
    print(f"written-frame pixels that differ, frame by frame: {moved}")
    assert max(moved) <= 0.001 * (H // 2) * W, f"pixels of the written frames differ: {moved}"


def test_fused_vidstream_miss_uses_the_programs_pose(estimators, trees, monkeypatch):
    """On a miss the loop takes the program's pose and never calls findBody."""
    _, port = estimators
    _, tdet = detector_pair(trees, MISS)
    tdet.face.l_iris = {"center": (10.0, 10.0), "radius": 5.0}
    monkeypatch.setattr(tdet, "findBody", lambda img: pytest.fail("staged findBody called"))
    vs = FusedVidStream(port, tdet, tdet.face, "synthetic:2x120x160", NullSink(), verbose=False)
    vs.stream()
    assert vs.cnt == 2 and vs.route_counts == {"iris": 0, "body": 2}
    assert vs.timer.performance["body"] and len(vs.timer.performance["depth"]) == 2


def test_fused_vidstream_refuses_unfaithful_face(estimators, trees):
    """A ``faithful=False`` FaceDet is no longer refused: the fused loop's
    runner then emits the f32 map (for the host's samples), and with a
    faithful face it does not."""
    _, port = estimators
    _, tdet = detector_pair(trees, HIT)
    loose = FusedVidStream(port, tdet, FaceDet(20, CARD, faithful=False), "synthetic:2x120x160")
    faithful = FusedVidStream(port, tdet, tdet.face, "synthetic:2x120x160")
    assert loose._runner.emit_depth_map and not faithful._runner.emit_depth_map
    for vs in (loose, faithful):
        vs.video.release()


@pytest.mark.parametrize("thresh,kw", [(MIXED, {"pipeline_depth": 2}), (MIXED, {"microbatch": 2})],
                         ids=["mixed_depth2", "mixed_microbatch2"])
def test_unfaithful_fused_vidstream_matches_jax(estimators, trees, thresh, kw):
    """With a ``faithful=False`` FaceDet the host samples the fetched f32 map
    (``get_depth`` without the reference's quirks): the same samples,
    distances, routes and written frames as JAX's loop."""
    from depth_estimation_tpu.geometry.face import FaceDet as JaxFaceDet

    ref, port = estimators
    jdet, tdet = detector_pair(trees, thresh)
    jdet.face, tdet.face = JaxFaceDet(20, CARD, faithful=False), FaceDet(20, CARD, faithful=False)
    runs = []
    for cls, sink, est, det in ((JaxFusedVidStream, _collector(JaxNullSink), ref, jdet),
                                (FusedVidStream, _collector(NullSink), port, tdet)):
        vs = cls(est, det, det.face, "synthetic:8x120x160", sink, verbose=False, **kw)
        routes = []
        for name in ("_iris_path", "_body_path"):
            orig = getattr(vs, name)
            setattr(vs, name, lambda vis, orig=orig, name=name: (routes.append(name), orig(vis))[1])
        vs.stream()
        runs.append((det.face, sink.frames, routes))
    (jface, jframes, jroutes), (tface, tframes, troutes) = runs
    assert troutes == jroutes and set(troutes) == {"_iris_path", "_body_path"}
    assert len(tface.ri_depths) == len(jface.ri_depths) > 0
    for key in ("ri_depths", "abs_depths", "s2c_ds", "head_measurements"):
        np.testing.assert_allclose(getattr(tface, key), getattr(jface, key), rtol=1e-5, err_msg=key)
    moved = [int((g != w).any(axis=-1).sum()) for g, w in zip(tframes, jframes)]
    assert len(tframes) == len(jframes) == 8 and max(moved) <= 0.001 * (H // 2) * W, moved


def test_entry_point_writes_an_avi(tmp_path):
    """``python -m depth_estimation_tpu_torch.midas_mediapipe --device cpu``
    runs the whole fused loop (MiDaS_small, whose random weights are the
    lightest to build) and writes an .avi; with no GPU, the default device
    refuses."""
    out = tmp_path / "fused.avi"
    cmd = [sys.executable, "-m", "depth_estimation_tpu_torch.midas_mediapipe", "--device", "cpu",
           "--model-type", "MiDaS_small", "--src", "synthetic:3x120x160", "--output", str(out)]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Frame: 3" in r.stdout and "Performance stats in FPS:" in r.stdout
    assert out.exists() and out.stat().st_size > 0
    if not torch.cuda.is_available():
        r = subprocess.run(cmd[:3] + cmd[5:], cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
        assert r.returncode != 0 and "no CUDA GPU" in r.stderr
