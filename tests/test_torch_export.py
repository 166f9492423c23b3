"""The port's export surface (``utils/export.py``, ``tools/export_program.py``)
on the CPU, and the small surface.

* The kernels K1–K4 are ``torch.library`` operators: ``opcheck`` on each, and
  each exported graph calls them as often as the live program does.
* Round trips held as the JAX package's ``tests/test_export.py`` holds its
  own: the loaded artifact against the port's live program (bit for bit for
  the frame programs, every field for the fused one), and against the JAX
  package's loaded artifact on the same weights (max-scaled 1e-4 for depth;
  the fused fields at ``tests/test_torch_fused.py``'s tolerances).
* The weights stay out of the archive, a process that imports only the
  operators loads and runs it, and the CLI writes a loadable file.
* ``__version__`` and ``FusedVidStream.detect_points`` / ``.to_video_frame``
  against the JAX package's.
"""

import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

import depth_estimation_tpu
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.runtime.stream import FusedVidStream as JaxFusedVidStream
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu.utils import export as jexport
import depth_estimation_tpu_torch
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS, LEFT_IRIS, RIGHT_IRIS, SMALL_PREPROCESS
from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
from depth_estimation_tpu_torch.estimator import DepthEstimator, random_state_dict
from depth_estimation_tpu_torch.geometry.face import FaceDet
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.models.midas_v21 import MidasV21
from depth_estimation_tpu_torch.ops.kernels import attention as tatt
from depth_estimation_tpu_torch.ops.kernels import dense as tlin
from depth_estimation_tpu_torch.ops.kernels import grouped_conv as tgc
from depth_estimation_tpu_torch.ops.kernels import resize as trsz
from depth_estimation_tpu_torch.runtime.fused import make_fused_iris_frame_fn
from depth_estimation_tpu_torch.runtime.stream import FusedVidStream
from depth_estimation_tpu_torch.runtime.video import NullSink
from depth_estimation_tpu_torch.tools import export_program
from depth_estimation_tpu_torch.utils import convert
from depth_estimation_tpu_torch.utils.export import export_frame_program, export_fused_program, load_frame_program
from tests.test_fused_iris import _make_detector
from tests.test_torch_detect import detector_pair, detector_trees
from tests.test_torch_dpt import TINY as TINY_DPT
from tests.test_torch_fused import _max_scaled, assert_mesh_rule, jax_float_mesh_fn
from tests.test_torch_midas_v21 import TINY as TINY_MIDAS_V21

HW = (64, 96)
FUSED_HW = (120, 160)
OPS = {"attention": torch.ops.depth_tpu_torch.attention.default,
       "preprocess": torch.ops.depth_tpu_torch.preprocess.default,
       "resize_planes": torch.ops.depth_tpu_torch.resize_planes.default,
       "grouped_conv3x3": torch.ops.depth_tpu_torch.grouped_conv3x3.default,
       "linear": torch.ops.depth_tpu_torch.linear.default}
# the plain version that each operator's CPU implementation calls: (module, function name)
PLAIN = {"attention": (tatt, "attention_plain"), "preprocess": (trsz, "preprocess_plain"),
         "resize_planes": (trsz, "resize_planes_plain"), "grouped_conv3x3": (tgc, "grouped_conv3x3_plain"),
         "linear": (tlin, "linear_plain")}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: the CPU suite runs six
    workers on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def estimators():
    """(JAX MiDaS_small, the port's on the same weights through
    ``params_from_jax_midas_small``), as the JAX export test builds its own."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxEstimator("MiDaS_small", verbose=False)
    port = DepthEstimator("MiDaS_small", params=convert.params_from_jax_midas_small(ref.params), verbose=False,
                          device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def frame_blob(estimators):
    """The port's MiDaS_small single-frame program at ``HW``."""
    return export_frame_program(estimators[1], HW)


def _max_scaled_depth(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


# -- the kernels as operators -----------------------------------------------------


def _op_case(name, g):
    if name == "attention":
        return (*(torch.randn((1, 2, 17, 64), generator=g, requires_grad=True) for _ in range(3)),)
    if name == "preprocess":
        img = torch.randint(0, 256, (2, 20, 24, 3), generator=g, dtype=torch.uint8)
        return img, [12, 16], [0.485, 0.456, 0.406], [0.229, 0.224, 0.225], True, "cubic"
    if name in ("linear", "linear_no_bias"):
        return (torch.randn((2, 5, 64), generator=g, requires_grad=True),
                torch.randn((96, 64), generator=g, requires_grad=True),
                torch.randn((96,), generator=g, requires_grad=True) if name == "linear" else None, name == "linear")
    if name in ("resize_f32", "resize_u8"):
        x = 40 * torch.randn((2, 12, 16), generator=g)
        return x.requires_grad_(name == "resize_f32"), [20, 28], "cubic", False, name.split("_")[1]
    return (torch.randn((2, 16, 7, 9), generator=g, requires_grad=True),
            torch.randn((16, 4, 3, 3), generator=g, requires_grad=True), 4)


@pytest.mark.parametrize("case", ["attention", "preprocess", "resize_f32", "resize_u8", "grouped_conv3x3", "linear",
                                  "linear_no_bias"])
def test_operators_pass_opcheck(case):
    """Schema, autograd registration, the fake implementation against the
    CPU one (shape, dtype, strides) and tracing through AOT autograd."""
    op = OPS["resize_planes" if case.startswith("resize") else "linear" if case.startswith("linear") else case]
    result = torch.library.opcheck(op, _op_case(case, torch.Generator().manual_seed(0)))
    assert set(result.values()) == {"SUCCESS"}, result


def _operator_nodes(program) -> dict:
    targets = [node.target for node in program.exported.graph.nodes if node.op == "call_function"]
    return {name: targets.count(op) for name, op in OPS.items()}


def _live_calls(monkeypatch, fn) -> dict:
    """Each operator's calls while ``fn`` runs on CPU tensors, counted at its
    CPU implementation's plain version."""
    calls = dict.fromkeys(OPS, 0)
    for name, (mod, attr) in PLAIN.items():
        plain = getattr(mod, attr)

        def counted(*a, _plain=plain, _name=name):
            calls[_name] += 1
            return _plain(*a)

        monkeypatch.setattr(mod, attr, counted)
    fn()
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("family", ["dpt", "midas_v21"])
def test_exported_graph_calls_the_operators_as_the_live_program(monkeypatch, rng, family):
    """The tiny DPT: K1 once a block, K2 1, K3 1, the linear kernel four times
    a block and once a readout; the tiny MiDaS v2.1: K4 once a stride-1
    bottleneck. The graph names each operator as often as the live program
    calls it."""
    name = f"export_test_tiny_{family}"
    make, cfg = ((lambda: DPT(TINY_DPT)), DPT_PREPROCESS) if family == "dpt" else (
        (lambda: MidasV21(TINY_MIDAS_V21)), SMALL_PREPROCESS)
    treg.register(treg.ModelEntry(name, make, cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = DepthEstimator(name, verbose=False, device="cpu")
    img = rng.integers(0, 256, (*HW, 3), np.uint8)
    live = _live_calls(monkeypatch, lambda: est.predict(img))
    nodes = _operator_nodes(load_frame_program(export_frame_program(est, HW)))
    assert nodes == live
    if family == "dpt":
        assert nodes == {"attention": TINY_DPT.depth, "preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 0,
                         "linear": 4 * TINY_DPT.depth + 4}
    else:
        assert nodes["grouped_conv3x3"] >= 1 and nodes["attention"] == 0 and nodes["linear"] == 0


# -- round trips ------------------------------------------------------------------------


def test_export_roundtrip_single_frame(estimators, frame_blob, tmp_path, rng):
    """From disk, as a serving process would: bit for bit the port's live
    ``predict``, and within max-scaled 1e-4 of the JAX package's loaded
    artifact on the same weights."""
    ref, port = estimators
    img = rng.integers(0, 256, (*HW, 3), np.uint8)
    path = tmp_path / "midas_small.pt2"
    path.write_bytes(frame_blob)
    fn = load_frame_program(path)
    out = fn(port.params, img)
    assert out.device.type == "cpu" and fn.record["kind"] == "frame"
    np.testing.assert_array_equal(out.numpy(), port.predict(img))
    jfn = jexport.load_frame_program(jexport.export_frame_program(ref, HW))
    _max_scaled_depth(out.numpy(), np.asarray(jfn(ref.params, img)))


def test_export_roundtrip_batched(estimators, rng):
    ref, port = estimators
    imgs = rng.integers(0, 256, (2, *HW, 3), np.uint8)
    fn = load_frame_program(export_frame_program(port, HW, batched=True, batch=2))
    out = fn(port.params, imgs).numpy()
    np.testing.assert_array_equal(out, port.predict_batch(imgs))
    jfn = jexport.load_frame_program(jexport.export_frame_program(ref, HW, batched=True, batch=2))
    _max_scaled_depth(out, np.asarray(jfn(ref.params, imgs)))


def test_export_roundtrip_fused(estimators, rng):
    """The fused program on the JAX export test's detector (``_make_detector``:
    random Flax nets, threshold 1e-4, so the mesh branch runs), converted:
    every field equal to the port's live fused program, and held against the
    JAX package's loaded fused artifact at ``tests/test_torch_fused.py``'s
    tolerances (boxes and scores 1e-5, valid exact, mesh by the ±1 rule,
    circles 1e-3, pose max-scaled 1e-4, samples rtol 1e-5, vis_u8 equal
    except where the f32 map lies within 1e-3 of an integer)."""
    ref, port = estimators
    jdet, _face = _make_detector()
    params = {"blazeface": convert.params_from_jax_blazeface(jdet._face_det_params["params"]),
              "facemesh": convert.params_from_jax_facemesh(jdet._mesh_params["params"]),
              "blazepose": convert.params_from_jax_blazepose(jdet._pose_params["params"])}
    tdet = PersonDetector(FaceDet(20, [505, 504, 675, 501]), minDetectionCon=jdet.minDetectionCon, params=params,
                          device="cpu")
    img = rng.integers(0, 256, (*FUSED_HW, 3), np.uint8)
    pts = np.int32([[40, 50], [60, 50]])
    states = (port.params, tdet._face_det.state_dict(), tdet._mesh.state_dict(), tdet._pose.state_dict())
    out = {k: v.numpy() for k, v in load_frame_program(export_fused_program(port, tdet, FUSED_HW))(
        *states, img, pts).items()}
    live = make_fused_iris_frame_fn(port, tdet, FUSED_HW, include_pose=True, emit_depth_map=False)
    want = {k: v[0].numpy() for k, v in live(torch.from_numpy(img)[None], torch.from_numpy(pts)[None]).items()}
    assert set(out) == set(want) and "depth" not in out
    for k in want:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)

    jfn = jexport.load_frame_program(jexport.export_fused_program(ref, jdet, FUSED_HW, include_pose=True))
    jout = jax.device_get(jfn(ref.params, jdet._face_det_params, jdet._mesh_params, jdet._pose_params, img, pts))
    jout = {k: np.asarray(v) for k, v in jout.items()}
    assert set(out) == set(jout)
    assert bool(jout["valid"][0]), "threshold 1e-4 must detect"
    depth = ref.predict(img)  # the JAX map, for the u8 rule and the samples' scale
    np.testing.assert_array_equal(out["valid"], jout["valid"])
    for key in ("boxes", "scores", "mesh_score"):
        np.testing.assert_allclose(out[key], jout[key], atol=1e-5, rtol=0, err_msg=key)
    _max_scaled(out["pose_lm"], jout["pose_lm"], what="pose_lm")
    np.testing.assert_allclose(out["pose_score"], jout["pose_score"], atol=1e-4, rtol=0)
    assert_mesh_rule(out["mesh"], jout["mesh"], jax_float_mesh_fn(jdet, *FUSED_HW)(img, jout["boxes"]))
    for side, idx in (("l", list(LEFT_IRIS)), ("r", list(RIGHT_IRIS))):
        tol = 1e-3 if (out["mesh"][idx] == jout["mesh"][idx]).all() else 1.0 + 1e-3
        np.testing.assert_allclose(out[f"{side}_center"], jout[f"{side}_center"], atol=tol, rtol=0)
        np.testing.assert_allclose(out[f"{side}_radius"], jout[f"{side}_radius"], atol=tol, rtol=0)
    for key in ("iris_sample", "fallback_sample", "ears_sample"):
        np.testing.assert_allclose(out[key], jout[key], rtol=1e-5, atol=1e-6 * np.abs(depth).max(), err_msg=key)
    differ = out["vis_u8"] != jout["vis_u8"]
    assert not (differ & (np.abs(depth - np.round(depth)) >= 1e-3)).any()


def _weight_bytes(state):
    return sum(t.numel() * t.element_size() for t in state.values())


def test_archive_holds_no_weights(estimators, frame_blob, rng):
    """Under 5% of the weights' bytes, and another checkpoint of the same
    architecture given to the artifact gives that checkpoint's live output."""
    _, port = estimators
    assert len(frame_blob) < 0.05 * _weight_bytes(port.params)
    fn = load_frame_program(frame_blob)
    assert not fn.exported.state_dict
    other = random_state_dict(port.model, seed=1)
    img = rng.integers(0, 256, (*HW, 3), np.uint8)
    live = DepthEstimator("MiDaS_small", params=other, verbose=False, device="cpu").predict(img)
    np.testing.assert_array_equal(fn(other, img).numpy(), live)


def test_loaded_program_refuses_another_device(estimators, frame_blob):
    _, port = estimators
    fn = load_frame_program(frame_blob)
    meta = {k: v.to("meta") for k, v in port.params.items()}
    with pytest.raises(ValueError, match="exported for cpu"):
        fn(meta, np.zeros((*HW, 3), np.uint8))


_LOAD_ALONE = """
import sys
import numpy as np
import torch
import depth_estimation_tpu_torch.ops.kernels
from depth_estimation_tpu_torch.utils.export import load_frame_program

torch.set_num_threads(2)
want = torch.load(sys.argv[2])
out = load_frame_program(sys.argv[1])(want["params"], want["img"])
assert torch.equal(out, want["out"]), "the loaded program differs from the live one"
loaded = sorted(m for m in sys.modules if m.startswith("depth_estimation_tpu_torch."))
assert not any(m.startswith(("depth_estimation_tpu_torch.models", "depth_estimation_tpu_torch.estimator"))
               for m in loaded), loaded
print(loaded)
"""


def test_loading_needs_only_the_operators(estimators, frame_blob, tmp_path, rng):
    """A fresh process that imports the operator registrations (and the
    loader, which imports nothing else of the port) loads and runs the
    artifact, without the models."""
    _, port = estimators
    img = rng.integers(0, 256, (*HW, 3), np.uint8)
    (tmp_path / "p.pt2").write_bytes(frame_blob)
    torch.save({"params": port.params, "img": torch.from_numpy(img), "out": torch.from_numpy(port.predict(img))},
               tmp_path / "want.pt")
    r = subprocess.run([sys.executable, "-c", _LOAD_ALONE, str(tmp_path / "p.pt2"), str(tmp_path / "want.pt")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# -- the CLI ----------------------------------------------------------------------------


def test_cli_writes_a_loadable_program(monkeypatch, tmp_path, rng, capsys):
    monkeypatch.setenv("DEPTH_ESTIMATION_TPU_TORCH_CACHE", str(tmp_path / "cache"))  # no stray weights
    out = tmp_path / "small.pt2"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        export_program.main(["--model-type", "MiDaS_small", "--hw", *map(str, HW), "--out", str(out),
                             "--device", "cpu"])
        est = DepthEstimator("MiDaS_small", verbose=False, device="cpu")  # the CLI's weights: seed 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"exported MiDaS_small ({HW[0]}, {HW[1]}, 3) -> {out} ({out.stat().st_size} bytes)"
    fn = load_frame_program(out)
    assert fn.record["model_type"] == "MiDaS_small" and fn.record["device"] == "cpu"
    img = rng.integers(0, 256, (*HW, 3), np.uint8)
    np.testing.assert_array_equal(fn(est.params, img).numpy(), est.predict(img))


@pytest.mark.parametrize("argv,message", [(["--batch", "2"], "--batch requires --batched"),
                                          (["--fused", "--batched"], "--fused exports the single-frame")])
def test_cli_argument_errors(tmp_path, capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        export_program.main(["--out", str(tmp_path / "x.pt2"), "--device", "cpu", *argv])
    assert exc.value.code == 2 and message in capsys.readouterr().err
    assert not (tmp_path / "x.pt2").exists()


# -- the small surface ------------------------------------------------------------------


def test_version_is_the_jax_packages():
    assert depth_estimation_tpu_torch.__version__ == depth_estimation_tpu.__version__ == "0.1.0"
    assert "__version__" in depth_estimation_tpu_torch.__all__


@pytest.fixture(scope="module")
def trees():
    return detector_trees()


def _streams(estimators, trees, thresh):
    """JAX's and the port's FusedVidStream on one set of detector weights."""
    ref, port = estimators
    jdet, tdet = detector_pair(trees, thresh)
    return (JaxFusedVidStream(ref, jdet, jdet.face, "synthetic:1x120x160", JaxNullSink(), verbose=False),
            FusedVidStream(port, tdet, tdet.face, "synthetic:1x120x160", NullSink(), verbose=False))


@pytest.mark.parametrize("thresh", [0.2, 2.0], ids=["iris", "body"])
def test_detect_points_matches_jax(estimators, trees, rng, thresh):
    """Iris first (the same face state), body on a miss (the same landmarks),
    as the reference's helper."""
    jvs, tvs = _streams(estimators, trees, thresh)
    img = rng.integers(0, 256, (*FUSED_HW, 3), np.uint8)
    for vs in (jvs, tvs):
        vs.face.mesh = None
        vs.detect_points(img.copy())
    jdet, tdet = jvs.detector, tvs.detector
    if thresh < 1:
        assert tdet.face.mesh is not None and jdet.face.mesh is not None
        assert np.abs(tdet.face.mesh - jdet.face.mesh).max() <= 1
        assert (tdet.face.mesh == jdet.face.mesh).mean() > 0.99
    else:
        assert tdet.face.mesh is None and jdet.face.mesh is None
        _max_scaled(tdet.results["landmarks"], jdet.results["landmarks"], what="pose landmarks")


def test_to_video_frame_matches_jax(estimators, trees, rng):
    jvs, tvs = _streams(estimators, trees, 0.2)
    depth = (rng.standard_normal(FUSED_HW) * 300).astype(np.float32)
    got = tvs.to_video_frame(depth)
    assert got.shape == (*FUSED_HW, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jvs.to_video_frame(depth))
