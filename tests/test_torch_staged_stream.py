"""The port's staged loop (``FusedVidStream(fused=False)``, ``--no-fused``)
against the JAX package's on the CPU, with the same weights: the tiny DPT
of tests/test_torch_fused.py and the detector nets through
``params_from_jax_*``. Also ``--trace`` on the three entry points."""

import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry.face import FaceDet as JaxFaceDet
from depth_estimation_tpu.runtime.stream import FusedVidStream as JaxFusedVidStream
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu_torch import cli, midas_mediapipe
from depth_estimation_tpu_torch.config import CARD
from depth_estimation_tpu_torch.geometry.face import FaceDet
from depth_estimation_tpu_torch.runtime.stream import FusedVidStream
from depth_estimation_tpu_torch.runtime.tracing import maybe_trace, span
from depth_estimation_tpu_torch.runtime.video import NullSink
from tests.test_torch_detect import detector_pair, detector_trees
from tests.test_torch_detection import jax_float_mesh  # noqa: F401  (a fixture)
from tests.test_torch_estimator import _collector
from tests.test_torch_fused import MIXED, assert_mesh_rule, estimators  # noqa: F401  (a fixture)

H, W = 120, 160


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads a worker while this module runs (six workers share the host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def detectors():
    """(JAX PersonDetector, port PersonDetector) at the threshold where
    synthetic:8x120x160's frames 1-4 detect and 5-8 do not."""
    return detector_pair(detector_trees(), MIXED)


def _staged_run(cls, est, det, face, sink):
    """One staged stream over synthetic:6x120x160; keeps each frame's face
    mesh as the loop found it, and the routes taken."""
    det.face = face
    vs = cls(est, det, face, f"synthetic:6x{H}x{W}", sink, verbose=False, fused=False)
    seen, routes = [], []
    route = vs._route_frame
    vs._route_frame = lambda vis: (seen.append((vs.frame.copy(), None if face.mesh is None else face.mesh.copy())),
                                   route(vis))[1]
    for name in ("_iris_path", "_body_path"):
        orig = getattr(vs, name)
        setattr(vs, name, lambda vis, orig=orig, name=name: (routes.append(name), orig(vis))[1])
    vs.stream()
    return vs, seen, routes


@pytest.mark.parametrize("faithful", [True, False], ids=["faithful_face", "corrected_face"])
def test_staged_stream_matches_jax(estimators, detectors, jax_float_mesh, tmp_path, capsys,  # noqa: F811
                                   faithful):
    """Frame by frame: the same route, the face mesh by the ±1 rule (JAX's
    float landmarks), and the same depth samples and distances (rtol 1e-5),
    with a faithful FaceDet (host sampling with the reference's quirks) and
    a corrected one (faithful=False, accepted on this path only). The port's
    run is traced: ``maybe_trace`` writes a trace file."""
    (ref, port), (jdet, tdet) = estimators, detectors
    jvs, jseen, jroutes = _staged_run(JaxFusedVidStream, ref, jdet, JaxFaceDet(20, CARD, faithful=faithful),
                                      _collector(JaxNullSink))
    with maybe_trace(True, str(tmp_path / "trace")) as tdir:
        tvs, tseen, troutes = _staged_run(FusedVidStream, port, tdet, FaceDet(20, CARD, faithful=faithful),
                                          _collector(NullSink))
    assert tdir == str(tmp_path / "trace") and list((tmp_path / "trace").glob("trace_*.json"))
    assert troutes == jroutes and len(troutes) == 6
    assert set(troutes) == {"_iris_path", "_body_path"}, "the threshold must take both routes"
    for (frame, tmesh), (_, jmesh) in zip(tseen, jseen):
        assert (tmesh is None) == (jmesh is None)
        if jmesh is not None:
            boxes = np.asarray(jdet._detect_fn((H, W), "face")(jdet._face_det_params, frame)[0])
            assert_mesh_rule(tmesh, jmesh, jax_float_mesh(jdet._mesh_params, frame, boxes, False))
    tface, jface = tdet.face, jdet.face
    assert len(tface.ri_depths) == len(jface.ri_depths) > 0
    for key in ("ri_depths", "abs_depths", "s2c_ds", "head_measurements"):
        np.testing.assert_allclose(getattr(tface, key), getattr(jface, key), rtol=1e-5, err_msg=key)
    assert len(tvs.writer.frames) == len(jvs.writer.frames) == 6
    assert len(tvs.timer.performance["depth"]) == len(tvs.timer.performance["iris"]) == 6
    assert tvs.timer.performance["body"] and tvs.route_counts == {"iris": troutes.count("_iris_path"),
                                                                 "body": troutes.count("_body_path")}
    assert "Performance stats in FPS:" in capsys.readouterr().out


def test_staged_stream_refuses_microbatches_and_takes_a_corrected_face(estimators, detectors):  # noqa: F811
    _, port = estimators
    _, tdet = detectors
    with pytest.raises(ValueError, match="microbatch>1 requires the fused"):
        FusedVidStream(port, tdet, tdet.face, f"synthetic:2x{H}x{W}", NullSink(), fused=False, microbatch=2)
    # the fused loop takes a corrected face too, its runner emitting the f32 map for the host's samples
    assert FusedVidStream(port, tdet, FaceDet(20, CARD, faithful=False), f"synthetic:2x{H}x{W}",
                          NullSink())._runner.emit_depth_map
    vs = FusedVidStream(port, tdet, FaceDet(20, CARD, faithful=False), f"synthetic:2x{H}x{W}", NullSink(),
                        fused=False)
    assert vs._runner is None


@pytest.mark.parametrize("entry,extra", [(midas_mediapipe, ["--no-fused"]), (midas_mediapipe, []), (cli, [])],
                         ids=["midas_mediapipe_staged", "midas_mediapipe_fused", "depth_midas"])
def test_entry_points_trace(tmp_path, capsys, monkeypatch, entry, extra):
    """``--trace`` (default directory ./torch_trace) on the staged and fused
    fused-path entry and the depth-only one, MiDaS_small, 2 frames, on the
    CPU: each writes its .avi and one trace file, and says where."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out.avi"
    entry.main(["--model-type", "MiDaS_small", "--src", "synthetic:2x96x128", "--output", str(out),
                "--device", "cpu", "--quiet", "--trace"] + extra)
    text = capsys.readouterr().out
    assert "Trace written to ./torch_trace" in text
    assert len(list((tmp_path / "torch_trace").glob("trace_*.json"))) == 1
    assert out.exists() and out.stat().st_size > 0
    if entry is midas_mediapipe:
        assert "Performance stats in FPS:" in text and ("Iris:" in text) == ("--no-fused" in extra)


def test_span_names_a_region_of_the_trace(tmp_path):
    with maybe_trace(True, str(tmp_path)):
        with span("staged_depth"):
            torch.ones(4).sum()
    (trace,) = tmp_path.glob("trace_*.json")
    assert '"staged_depth"' in trace.read_text()
    with maybe_trace(False, str(tmp_path / "off")) as tdir:
        pass
    assert tdir is None and not (tmp_path / "off").exists()
