"""The port's ``.tflite`` route against the JAX package's, on the CPU: the
flatbuffer reader and writer (the port's by hand, the JAX package's on the
``flatbuffers`` package, both ways), the layer order, the structural
converters on full-size files, ``BlazePoseDetector`` and the pose detector
stage, the weight cache (``detect/weights.py``), ``import_weights --tflite``
and the auto-loaded detectors end to end."""

import json
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

flatbuffers = pytest.importorskip("flatbuffers")

import jax  # noqa: E402

from depth_estimation_tpu.detect.person_detector import PersonDetector as JaxPersonDetector  # noqa: E402
from depth_estimation_tpu.geometry.face import FaceDet as JaxFaceDet  # noqa: E402
from depth_estimation_tpu.models import blazeface as jbf  # noqa: E402
from depth_estimation_tpu.models import blazepose as jbp  # noqa: E402
from depth_estimation_tpu.models import facemesh as jfm  # noqa: E402
from depth_estimation_tpu.tools import import_weights as jimport  # noqa: E402
from depth_estimation_tpu.utils import convert as jconv  # noqa: E402
from depth_estimation_tpu.utils import tflite as jtfl  # noqa: E402
from depth_estimation_tpu.utils import tflite_synth as jsynth  # noqa: E402
from depth_estimation_tpu_torch.config import CARD  # noqa: E402
from depth_estimation_tpu_torch.detect import weights as tweights  # noqa: E402
from depth_estimation_tpu_torch.detect.face_detector import FaceDetector  # noqa: E402
from depth_estimation_tpu_torch.detect.person_detector import PersonDetector  # noqa: E402
from depth_estimation_tpu_torch.estimator import random_state_dict  # noqa: E402
from depth_estimation_tpu_torch.geometry.face import FaceDet  # noqa: E402
from depth_estimation_tpu_torch.models.blazeface import BlazeFace  # noqa: E402
from depth_estimation_tpu_torch.models.blazepose import BlazePose, BlazePoseDetector  # noqa: E402
from depth_estimation_tpu_torch.models.facemesh import FaceMesh, FaceMeshWithIris, IrisLandmark  # noqa: E402
from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner  # noqa: E402
from depth_estimation_tpu_torch.tools import import_weights as timport  # noqa: E402
from depth_estimation_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from depth_estimation_tpu_torch.utils import convert as tconv  # noqa: E402
from depth_estimation_tpu_torch.utils import tflite as ttfl  # noqa: E402
from depth_estimation_tpu_torch.utils import tflite_synth as tsynth  # noqa: E402
from tests.test_tflite import _build_tflite  # noqa: E402
from tests.test_tflite_convert import _build_tflite_with_ops  # noqa: E402
from tests.test_torch_detect import detector_trees  # noqa: E402

# file → (JAX net, NHWC input, port net, extra branch layers); in detect/weights.py's names
FILES = {
    "face_detection_short_range.tflite": (jbf.BlazeFace, (1, 128, 128, 3), BlazeFace, 0),
    "face_landmark.tflite": (jfm.FaceMesh, (1, 192, 192, 3), FaceMesh, 0),
    "iris_landmark.tflite": (jfm.IrisLandmark, (1, 64, 64, 3), IrisLandmark, 0),
    "pose_detection.tflite": (jbp.BlazePoseDetector, (1, 224, 224, 3), BlazePoseDetector, 0),
    "pose_landmark_full.tflite": (jbp.BlazePose, (1, 256, 256, 3), BlazePose, 3),
}
# params key → (its files, the JAX package's converter, the port's, JAX tree → port state dict)
CONVERTERS = {
    "blazeface": (("face_detection_short_range.tflite",), jconv.convert_blazeface_tflite,
                  tconv.convert_blazeface_tflite, tconv.params_from_jax_blazeface),
    "facemesh": (("face_landmark.tflite", "iris_landmark.tflite"), jconv.convert_facemesh_tflite,
                 tconv.convert_facemesh_tflite, tconv.params_from_jax_facemesh),
    "blazepose_detector": (("pose_detection.tflite",), jconv.convert_blazepose_detector_tflite,
                           tconv.convert_blazepose_detector_tflite, tconv.params_from_jax_blazepose_detector),
    "blazepose": (("pose_landmark_full.tflite",), jconv.convert_blazepose_tflite, tconv.convert_blazepose_tflite,
                  tconv.params_from_jax_blazepose),
}


def nchw(shape):
    return (shape[0], shape[3], shape[1], shape[2])


def meta(make):
    with torch.device("meta"):
        return make()


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The five MediaPipe files at full size, synthesized by the JAX package
    (RESHAPE/ADD noise, 3 extra branch convs in the pose landmark file):
    {file name: path}, and the trees they encode."""
    root = tmp_path_factory.mktemp("jax_tflite")
    rng = np.random.default_rng(0)
    paths, trees = {}, {}
    for name, (jmod, shape, _tmod, extra) in FILES.items():
        blob, trees[name] = jsynth.synthesize_model_file(jmod(), shape, rng, extra_branch_layers=extra)
        paths[name] = root / name
        paths[name].write_bytes(blob)
    return paths, trees


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _assert_sd_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], torch.as_tensor(want[k])), k


def _assert_streams_equal(got, want):
    (gops, gconsts, gnames), (wops, wconsts, wnames) = got, want
    assert [(o.op, o.inputs, o.outputs) for o in gops] == [(o.op, o.inputs, o.outputs) for o in wops]
    assert gconsts.keys() == wconsts.keys() and gnames == wnames
    for k in wconsts:
        assert gconsts[k].dtype == wconsts[k].dtype and gconsts[k].shape == wconsts[k].shape
        np.testing.assert_array_equal(gconsts[k], wconsts[k])


# -- the reader and the writer -----------------------------------------------------


def _miniature(tmp_path, rng):
    """The JAX package's miniature net file (tests/test_tflite_convert.py)."""
    layers = [("CONV_2D", [rng.standard_normal((8, 3, 3, 3)), rng.standard_normal(8)]),
              ("PRELU", [rng.standard_normal((1, 1, 8))]),
              ("DEPTHWISE_CONV_2D", [rng.standard_normal((1, 3, 3, 8)), rng.standard_normal(8)]),
              ("FULLY_CONNECTED", [rng.standard_normal((4, 512)), rng.standard_normal(4)])]
    path = tmp_path / "tiny_net.tflite"
    path.write_bytes(_build_tflite_with_ops(layers))
    return path


def _named(tmp_path, rng):
    """The JAX package's named-tensor file (tests/test_tflite.py): f32, uint8 and int32 weights, one activation."""
    path = tmp_path / "tiny.tflite"
    path.write_bytes(_build_tflite([("conv/kernel", rng.standard_normal((3, 3, 4, 8)).astype(np.float32)),
                                    ("lut", rng.integers(0, 255, (16,), dtype=np.uint8)),
                                    ("bias", rng.integers(-5, 5, (2, 2)).astype(np.int32))]))
    return path


@pytest.mark.parametrize("name", [*FILES, "miniature", "named"])
def test_reader_matches_jax(jax_files, tmp_path, rng, name):
    """The port's reader on files that the flatbuffers package wrote gives
    the JAX reader's ops, consts (bitwise, types kept) and names, and the
    same constant tensors by name."""
    path = {"miniature": _miniature, "named": _named}[name](tmp_path, rng) if name in ("miniature", "named") \
        else jax_files[0][name]
    _assert_streams_equal(ttfl.read_tflite_ops(path), jtfl.read_tflite_ops(str(path)))
    got, want = ttfl.read_tflite_tensors(path), jtfl.read_tflite_tensors(str(path))
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _opcode_file(codes):
    """A model whose operator-code table holds ``codes``: ("old", n) in the
    deprecated int8 field 0 alone, ("new", n) in builtin_code (field 3);
    one subgraph with one op of each code, tensors i → i + 1."""
    b = flatbuffers.Builder(1024)

    def vec_of(offsets):
        b.StartVector(4, len(offsets), 4)
        for off in reversed(offsets):
            b.PrependUOffsetTRelative(off)
        return b.EndVector()

    def ints(values):
        b.StartVector(4, len(values), 4)
        for v in reversed(values):
            b.PrependInt32(v)
        return b.EndVector()

    op_offsets = []
    for i in range(len(codes)):
        ins, outs = ints([i]), ints([i + 1])
        b.StartObject(3)
        b.PrependUint32Slot(0, i, 0)
        b.PrependUOffsetTRelativeSlot(1, ins, 0)
        b.PrependUOffsetTRelativeSlot(2, outs, 0)
        op_offsets.append(b.EndObject())
    ops_vec = vec_of(op_offsets)
    b.StartObject(5)
    b.PrependUOffsetTRelativeSlot(3, ops_vec, 0)
    subgraphs = vec_of([b.EndObject()])
    oc_offsets = []
    for field, code in codes:
        b.StartObject(4)
        if field == "old":
            b.PrependInt8Slot(0, code, 0)
        else:
            b.PrependInt32Slot(3, code, 0)
        oc_offsets.append(b.EndObject())
    opcodes = vec_of(oc_offsets)
    b.StartObject(5)
    b.PrependUOffsetTRelativeSlot(1, opcodes, 0)
    b.PrependUOffsetTRelativeSlot(2, subgraphs, 0)
    b.Finish(b.EndObject())
    return bytes(b.Output())


def test_reader_takes_the_deprecated_opcode_field_and_names_unknown_codes(tmp_path):
    path = tmp_path / "codes.tflite"
    path.write_bytes(_opcode_file([("old", 3), ("old", 54), ("new", 4), ("new", 200), ("old", 99), ("new", 0)]))
    got = ttfl.read_tflite_ops(path)
    _assert_streams_equal(got, jtfl.read_tflite_ops(str(path)))
    assert [o.op for o in got[0]] == ["CONV_2D", "PRELU", "DEPTHWISE_CONV_2D", "OP_200", "OP_99", "ADD"]


@pytest.mark.parametrize("case", ["dtypes", "blazeface"])
def test_writer_round_trips_through_jax_reader(tmp_path, rng, case):
    """The port's ``serialize_tflite`` read back by the JAX reader (and the
    port's) gives the stream it was given, consts bitwise with their types:
    a stream of f32, f16, int32 and uint8 consts, and BlazeFace's full-size
    stream from ``ordered_slots``."""
    if case == "dtypes":
        consts = {1: rng.standard_normal((4, 3, 3, 2)).astype(np.float32),
                  2: rng.standard_normal((4,)).astype(np.float16),
                  4: rng.integers(-9, 9, (2, 3)).astype(np.int32),
                  5: rng.integers(0, 256, (7,), dtype=np.uint8)}
        ops = [ttfl.TFLiteOp("CONV_2D", [0, 1, 2], [3]), ttfl.TFLiteOp("RESHAPE", [3, 4], [6]),
               ttfl.TFLiteOp("LOGISTIC", [6, 5], [7])]
    else:
        net = meta(BlazeFace)
        ops, consts = tsynth.to_tflite_stream(tsynth.ordered_slots(net, (1, 3, 128, 128),
                                                                   tsynth.fill_random(net.state_dict(), rng)))
    path = tmp_path / "port.tflite"
    path.write_bytes(tsynth.serialize_tflite(ops, consts))
    for read in (jtfl.read_tflite_ops, ttfl.read_tflite_ops):
        got_ops, got_consts, _names = read(str(path))
        assert [(o.op, o.inputs, o.outputs) for o in got_ops] == [(o.op, o.inputs, o.outputs) for o in ops]
        assert got_consts.keys() == consts.keys()
        for k, v in consts.items():
            assert got_consts[k].dtype == v.dtype
            np.testing.assert_array_equal(got_consts[k], v)


# -- the layer order and the converters ------------------------------------------------


@pytest.mark.parametrize("name", list(FILES))
def test_layer_order_matches_jax(name):
    jmod, shape, tmod, _extra = FILES[name]
    want = [".".join(p) for p in jconv.flax_layer_order(jmod(), shape)[0]]
    assert tconv.tflite_layer_order(meta(tmod), nchw(shape)) == want


@pytest.mark.parametrize("key", list(CONVERTERS))
def test_conversion_matches_jax(jax_files, key):
    """A full-size file that the JAX package wrote converts in the port to
    ``params_from_jax_*`` of the JAX package's conversion, bitwise; the pose
    landmark file's 3 extra branch convs are stepped over with a warning."""
    paths, _ = jax_files
    names, jax_convert, port_convert, from_jax = CONVERTERS[key]
    args = [str(paths[n]) for n in names]
    want = from_jax(_quiet(jax_convert, *args))
    if key == "blazepose":
        with pytest.warns(UserWarning, match="BlazePose: skipped 3 weight op"):
            got = port_convert(*args)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = port_convert(*args)
    _assert_sd_equal(got, want)


_FAILURE = re.compile(r"no TFLite weight matches layer (\S+) \(.*; (next op is \S+ kernel \([^)]*\)|op stream "
                      r"exhausted); position (\d+/\d+)")


@pytest.mark.parametrize("case", ["extra_branch_strict", "mismatched_stream"])
def test_failure_names_the_same_layer_as_jax(jax_files, rng, case):
    """Strict matching on the pose landmark file (extra branch convs
    mid-stream), and a stream whose first conv lost an output channel: both
    raise ValueError naming the layer, the next op and the position that
    the JAX package's names."""
    if case == "extra_branch_strict":
        name = "pose_landmark_full.tflite"
        ops, consts, _ = ttfl.read_tflite_ops(jax_files[0][name])
    else:
        name = "iris_landmark.tflite"
        ops, consts = jsynth.to_tflite_stream(jsynth.ordered_slots(jfm.IrisLandmark(), (1, 64, 64, 3),
                                                                   jax_files[1][name]), rng=rng)
        first = next(op for op in ops if op.op == "CONV_2D")
        consts[first.inputs[1]] = consts[first.inputs[1]][:-1]
    jmod, shape, tmod, _extra = FILES[name]
    with pytest.raises(ValueError, match="no TFLite weight matches") as jerr:
        jconv.assign_tflite_weights(ops, consts, jmod(), shape, "net")
    with pytest.raises(ValueError, match="no TFLite weight matches") as terr:
        tconv.assign_tflite_weights(ops, consts, meta(tmod), nchw(shape), "net")
    (jlayer, *jrest), (tlayer, *trest) = (_FAILURE.search(str(e.value)).groups() for e in (jerr, terr))
    assert tlayer == jlayer.replace("/", ".") and trest == jrest


# -- BlazePoseDetector and the pose detector stage ------------------------------------


@pytest.fixture(scope="module")
def trees():
    """Random weights of the four detector nets (fan-in scaled); under
    ``"pose_nms"`` the pose detector's with its classifiers ×0.05 (scores
    that do not saturate, so kept scores do not tie) and its box regressors'
    widths and heights biased to 0.2 of its input (boxes with an area, so
    that NMS suppresses and blends)."""
    trees = detector_trees()
    pose = jax.tree_util.tree_map(np.copy, trees["blazepose_detector"])
    for tag in ("28", "14", "7"):
        pose[f"classifier_{tag}"]["kernel"] *= 0.05
        pose[f"regressor_{tag}"]["bias"].reshape(-1, 12)[:, 2:4] += 0.2 * 224
    return {**trees, "pose_nms": pose}


def test_blazepose_detector_matches_jax(trees, rng):
    """The forward on the same weights and a batch of 2 in [-1, 1]: raw
    boxes (2254 × 12, the heads flattened in NHWC order) and scores within
    1e-5 of their largest magnitude. The raw values reach some 160 on these
    weights, where one float32 step is 1.5e-5, so 1e-5 absolute would ask
    the two frameworks' convolutions to sum in the same order."""
    tree = trees["blazepose_detector"]
    x = rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    want = jax.jit(jbp.BlazePoseDetector().apply)({"params": tree}, x)
    net = BlazePoseDetector()
    net.load_state_dict(tconv.params_from_jax_blazepose_detector(tree))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got[0].shape == (2, 2254, 12) and got[1].shape == (2, 2254)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy() / np.abs(w).max(), w / np.abs(w).max(), atol=1e-5, rtol=0)


def test_pose_detect_fn_matches_jax(trees, rng):
    """``_detect_fn((240, 320), "pose")`` on a u8 BGR frame: K2's linear
    route to 224² (mean = std = 0.5), the net, decode over 2254 anchors,
    weighted NMS at IoU 0.3 and score 0.5; valid equal, scores at 1e-5, and
    boxes at 1e-5 where the top two kept scores lie 1e-4 apart or more."""
    params = {**{k: trees[k] for k in CONVERTERS}, "blazepose_detector": trees["pose_nms"]}
    img = rng.integers(0, 256, (240, 320, 3), np.uint8)
    jdet = JaxPersonDetector(JaxFaceDet(20, CARD), params=params)
    want = [np.asarray(a) for a in jdet._detect_fn((240, 320), "pose")(jdet._pose_det_params, img)]
    tdet = PersonDetector(FaceDet(20, CARD), params={k: CONVERTERS[k][3](t) for k, t in params.items()},
                          device="cpu")
    got = [t.numpy() for t in tdet._detect_fn((240, 320), "pose")(img)]
    assert got[0].shape == (16, 12)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    kept = want[1][want[2]]
    assert len(kept) >= 2 and kept[0] - kept[1] >= 1e-4, kept[:2]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="given to the"):
        tdet._detect_fn((240, 320), "pose")(img[:200])


# -- the weight cache, the CLI and the auto-loaded detectors ------------------------


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tckpt.CACHE_ENV, str(tmp_path / "torch_cache"))
    return tmp_path / "torch_cache"


def _stage(jax_files, names):
    dst = tweights.tflite_dir()
    dst.mkdir(parents=True, exist_ok=True)
    for n in names:
        shutil.copy2(jax_files[0][n], dst / n)


def test_load_detector_params_converts_once_and_caches(jax_files, port_cache, monkeypatch):
    """All five files: four nets converted, each cached with its files'
    content hashes ("+" between the mesh's two); a second call loads the
    cache (the converters raise if called)."""
    _stage(jax_files, FILES)
    first = _quiet(tweights.load_detector_params)
    assert set(first) == set(CONVERTERS)
    for key, (names, *_rest) in CONVERTERS.items():
        meta_json = json.loads((port_cache / f"detector_{key}" / "meta.json").read_text())
        assert meta_json["source_sha256"] == "+".join(tckpt.content_hash(tweights.tflite_dir() / n) for n in names)

    def refuse(*_args):
        raise AssertionError("converted again")

    for key in CONVERTERS:
        monkeypatch.setattr(tconv, CONVERTERS[key][2].__name__, refuse)
    second = tweights.load_detector_params()
    for key in first:
        _assert_sd_equal(second[key], first[key])


def test_a_changed_file_converts_again(jax_files, port_cache, rng):
    _stage(jax_files, ["face_detection_short_range.tflite"])
    old = tweights.load_detector_params()["blazeface"]
    blob, sd = tsynth.synthesize_model_file(meta(BlazeFace), (1, 3, 128, 128), rng)
    (tweights.tflite_dir() / "face_detection_short_range.tflite").write_bytes(blob)
    new = tweights.load_detector_params()["blazeface"]
    _assert_sd_equal(new, sd)
    assert not torch.equal(new["stem.weight"], old["stem.weight"])


@pytest.mark.parametrize("case", ["mesh_without_iris", "malformed"])
def test_a_net_without_a_usable_file_stays_random(jax_files, port_cache, case):
    """face_landmark.tflite without iris_landmark.tflite leaves FaceMesh
    random; a malformed pose_detection.tflite warns and leaves its net
    random. The others load, and the detector's warning names the random one."""
    _stage(jax_files, [n for n in FILES if not (case == "mesh_without_iris" and n == "iris_landmark.tflite")])
    key, seed_offset, make = (("facemesh", 1, FaceMeshWithIris) if case == "mesh_without_iris"
                              else ("blazepose_detector", 2, BlazePoseDetector))
    if case == "malformed":
        good = jax_files[0]["pose_detection.tflite"].read_bytes()
        (tweights.tflite_dir() / "pose_detection.tflite").write_bytes(good[:4] + b"\xff" * 64 + good[68:4096])
        with pytest.warns(UserWarning, match="TFLite conversion for 'blazepose_detector' unavailable"):
            params = tweights.load_detector_params()
        assert set(params) == set(CONVERTERS) - {key}
    with pytest.warns(UserWarning, match=rf"No detector weights in the cache for \['{key}'\]"):
        det = PersonDetector(FaceDet(20, CARD), seed=5, device="cpu")
    net = {"facemesh": det._mesh, "blazepose_detector": det._pose_det}[key]
    _assert_sd_equal(net.state_dict(), random_state_dict(meta(make), 5 + seed_offset))
    want = tconv.params_from_jax_blazeface(_quiet(jconv.convert_blazeface_tflite,
                                                  str(jax_files[0]["face_detection_short_range.tflite"])))
    _assert_sd_equal(det._face_det.state_dict(), want)


@pytest.mark.parametrize("case", ["converted", "no_match", "no_files"])
def test_import_weights_tflite(jax_files, port_cache, tmp_path, capsys, case):
    """rc 0 with the files (a line a file staged and a net converted), 1
    when no staged file has a name that detect/weights.py expects, 2 with no
    file or a missing one."""
    if case == "converted":
        paths = [str(jax_files[0][n]) for n in FILES]
        assert _quiet(timport.main, ["--tflite", *paths]) == 0
        out = capsys.readouterr().out.splitlines()
        assert sum(line.startswith("Staged ") for line in out) == 5
        assert {line.split()[3][:-1] for line in out if line.startswith("Converted + verified")} == set(CONVERTERS)
    elif case == "no_match":
        other = tmp_path / "selfie_segmentation.tflite"
        shutil.copy2(jax_files[0]["pose_detection.tflite"], other)
        assert timport.main(["--tflite", str(other)]) == 1
        assert "No detector matched" in capsys.readouterr().out
    else:
        assert timport.main(["--tflite"]) == 2
        assert timport.main(["--tflite", str(tmp_path / "absent.tflite")]) == 2
        assert "no such file" in capsys.readouterr().err
        assert not tweights.tflite_dir().exists()


def test_auto_loaded_detectors_match_jax_end_to_end(jax_files, port_cache, tmp_path, monkeypatch, rng):
    """The five files staged into both packages' caches by both CLIs: the
    JAX ``PersonDetector(params=None)`` trees, through ``params_from_jax_*``,
    equal the port's auto-loaded state dicts; the port's detection program
    on the CPU with the auto-loaded ``FaceDetector`` equals the same program
    on those state dicts given."""
    monkeypatch.setenv("DEPTH_ESTIMATION_TPU_CACHE", str(tmp_path / "jax_cache"))
    paths = [str(jax_files[0][n]) for n in FILES]
    assert _quiet(jimport.main, ["--tflite", *paths]) == 0
    assert _quiet(timport.main, ["--tflite", *paths]) == 0
    jdet = _quiet(JaxPersonDetector, JaxFaceDet(20, CARD))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tdet = PersonDetector(FaceDet(20, CARD), device="cpu")
        fd = FaceDetector(minDetectionCon=0.0, device="cpu")
    assert not [w for w in caught if "random" in str(w.message)]
    given = {}
    for key, jparams, net in (("blazeface", jdet._face_det_params, tdet._face_det),
                              ("facemesh", jdet._mesh_params, tdet._mesh),
                              ("blazepose_detector", jdet._pose_det_params, tdet._pose_det),
                              ("blazepose", jdet._pose_params, tdet._pose)):
        given[key] = CONVERTERS[key][3](jparams["params"])
        _assert_sd_equal(net.state_dict(), given[key])
    img = rng.integers(0, 256, (96, 128, 3), np.uint8)
    auto = FusedDetectionRunner(fd)(img)
    direct = FusedDetectionRunner(FaceDetector(minDetectionCon=0.0, params=given, device="cpu"))(img)
    for a, b in zip(auto, direct):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["random", "given"])
def test_rehearsal_writes_imports_and_auto_loads(trees, tmp_path, monkeypatch, case):
    """``tools/tflite_rehearsal.rehearse`` on the CPU (chip_smoke's ``tflite``
    phase drives it on the card): five files written at full size from
    random weights or from state dicts given, imported twice (the second a
    cache hit), and detectors built without params that hold exactly the
    files' state dicts. The caller's cache setting is restored."""
    from depth_estimation_tpu_torch.tools.tflite_rehearsal import rehearse

    monkeypatch.setenv(tckpt.CACHE_ENV, str(tmp_path / "callers_cache"))
    given = {k: CONVERTERS[k][3](trees[k]) for k in CONVERTERS} if case == "given" else None
    report = rehearse(tmp_path / "drop_cache", seed=1, weights=given, device="cpu", log=lambda *_: None)
    assert set(report["files"]) == set(FILES) and report["cached_import_seconds"] > 0
    assert tckpt.cache_dir() == tmp_path / "callers_cache" and not tckpt.cache_dir().exists()
    for key, sd in (given or report["weights"]).items():
        _assert_sd_equal(report["weights"][key], sd)
    _assert_sd_equal(report["person_detector"]._pose_det.state_dict(), report["weights"]["blazepose_detector"])
