"""The port's span recorder (``runtime/tracing.py``) and the spans of the
batcher, the stream loop and the frame program."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.estimator import DepthEstimator, random_state_dict
from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
from depth_estimation_tpu_torch.runtime import tracing
from depth_estimation_tpu_torch.runtime.server import DepthServer
from depth_estimation_tpu_torch.runtime.stream import VidStream
from depth_estimation_tpu_torch.runtime.video import SyntheticSource

NAME = "DPT_Tiny_tracing_test"
TINY = DPTConfig(embed_dim=64, depth=4, num_heads=2, hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
                 features=32, img_size=64)


def test_span_off_is_shared_and_records_nothing(monkeypatch):
    """Off: one shared object, no clock read, no profiler object made."""
    monkeypatch.setattr(tracing, "time", None)
    monkeypatch.setattr(torch.profiler, "record_function", None)
    a, b = tracing.span("x", req=1), tracing.span("y")
    assert a is b
    with a:
        tracing.emit("z", 0.0, 1.0, req=1)
    monkeypatch.undo()
    with tracing.record() as spans:
        pass
    with tracing.span("after"):
        pass
    assert spans == []


def _other():
    with tracing.span("other"):
        pass


def test_record_nests_by_thread_and_emits():
    with tracing.record() as spans:
        with tracing.span("outer", frame=3) as outer:
            with tracing.span("inner"):
                tracing.emit("waited", 1.0, 2.0, req=7)
            t = threading.Thread(target=_other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by = {s.name: s for s in spans}
    assert set(by) == {"outer", "inner", "waited", "other"}
    assert by["outer"].parent_id is None and by["outer"].ids == {"frame": 3} and by["outer"].span_id == outer.span_id
    assert by["inner"].parent_id == by["outer"].span_id
    assert by["waited"].parent_id == by["inner"].span_id and by["waited"][1:3] == (1.0, 2.0)
    assert by["waited"].ids == {"req": 7}
    assert by["other"].parent_id is None and by["other"].thread_id != by["outer"].thread_id
    assert by["outer"].start <= by["inner"].start <= by["inner"].end <= by["outer"].end


def test_record_under_many_threads_loses_nothing():
    """32 threads, each 200 nested pairs, switching every microsecond: every
    span kept once, each inner one under its own thread's outer one."""
    def work():
        for _ in range(200):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.record() as spans:
            threads = [threading.Thread(target=work) for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(spans) == 32 * 200 * 2 and len({s.span_id for s in spans}) == len(spans)
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent_id]
            assert parent.name == "outer" and parent.thread_id == s.thread_id
        else:
            assert s.parent_id is None


class _StandIn:
    """A frame program that takes 20 ms, under a ``program`` span."""

    def _batched_fn(self, hw, output="u8"):
        def fn(batch):
            with tracing.span("program", rows=len(batch)):
                time.sleep(0.02)
                return torch.from_numpy(batch[..., 0])

        return fn


def test_server_spans():
    """Six requests at max_batch 4: one server.queue span a request, ended
    before its batch's dispatch; pad, program, fetch and resolve under each
    dispatch; rows and padding fill the batch."""
    frames = [np.full((8, 12, 3), i, np.uint8) for i in range(6)]
    with tracing.record() as spans:
        srv = DepthServer(_StandIn(), (8, 12), max_batch=4, max_delay_ms=5)
        futs = [srv.submit(f) for f in frames]
        for i, fut in enumerate(futs):
            np.testing.assert_array_equal(fut.result(timeout=30), frames[i][..., 0])
        srv.close()
    queue = [s for s in spans if s.name == "server.queue"]
    assert sorted(s.ids["req"] for s in queue) == list(range(6))
    dispatch = {s.ids["batch"]: s for s in spans if s.name == "server.dispatch"}
    assert sum(d.ids["rows"] for d in dispatch.values()) == 6
    for d in dispatch.values():
        assert d.ids["rows"] + d.ids["padded"] == 4
        children = sorted((s for s in spans if s.parent_id == d.span_id), key=lambda s: s.start)
        assert [s.name for s in children] == ["server.pad", "program", "server.fetch", "server.resolve"]
    for q in queue:
        assert q.end <= dispatch[q.ids["batch"]].start and q.start <= q.end
    served = sorted(s.ids["batch"] for s in spans if s.name in ("server.idle", "server.collect"))
    assert set(dispatch) <= set(served)


@pytest.fixture(scope="module")
def tiny_estimator():
    treg.register(treg.ModelEntry(NAME, lambda: DPT(TINY), DPT_PREPROCESS))
    with torch.device("meta"):
        model = DPT(TINY)
    return DepthEstimator(NAME, params=random_state_dict(model, 0), verbose=False, device="cpu")


@pytest.mark.parametrize("microbatch", [1, 2])
def test_stream_spans(tiny_estimator, microbatch):
    """Each tick reads, dispatches, fetches and writes, in that order, with
    its first frame's index; the frame program (upload, K2, network, K3) runs
    inside the dispatch."""
    with tracing.record() as spans:
        VidStream(tiny_estimator, src=SyntheticSource(5, 48, 64), verbose=False, microbatch=microbatch).update()
    ticks = list(range(0, 5, microbatch))
    stream = [s for s in spans if s.name.startswith("stream.")]
    for first in ticks:
        mine = sorted((s for s in stream if s.ids["frame"] == first), key=lambda s: s.start)
        assert [s.name for s in mine] == ["stream.read", "stream.dispatch", "stream.fetch", "stream.write"]
        assert {s.ids["rows"] for s in mine[2:]} == {min(microbatch, 5 - first)}
    dispatch = {s.span_id: s for s in stream if s.name == "stream.dispatch"}
    programs = [s for s in spans if s.name == "program"]
    assert len(programs) == len(ticks) and all(p.parent_id in dispatch for p in programs)
    for p in programs:
        children = sorted((s for s in spans if s.parent_id == p.span_id), key=lambda s: s.start)
        assert [s.name for s in children] == ["program.upload", "program.k2", "program.network", "program.k3"]
        assert p.ids["rows"] == microbatch


@pytest.fixture(scope="module")
def fused_detector():
    """Random detector nets whose BlazeFace hits frames 0, 6 and 7 of
    ``synthetic:8x48x64`` and misses the others (best scores 0.9080, 0.9017,
    0.9001, 0.8999, 0.9015, 0.9013, 0.9129, 0.9134 against 0.905): its
    classifiers scaled down so that scores do not saturate, its box sizes
    biased so that face crops have an area (chip_smoke's rescale)."""
    from depth_estimation_tpu_torch.config import CARD
    from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
    from depth_estimation_tpu_torch.geometry.face import FaceDet

    det = PersonDetector(FaceDet(20, np.array(CARD)), minDetectionCon=0.905, params={}, device="cpu")
    sd = {k: v.clone() for k, v in det._face_det.state_dict().items()}
    for tag in ("16", "8"):
        sd[f"classifier_{tag}.weight"] *= 0.05
        sd[f"regressor_{tag}.weight"] *= 0.5
        sd[f"regressor_{tag}.bias"].view(-1, 16)[:, 2:4] += 0.2 * 128
    det._face_det.load_state_dict(sd)
    return det


def _fused_stream(estimator, detector):
    """``FusedVidStream`` over synthetic:8x48x64 at microbatch 4 on a fresh
    face; returns the stream and the side-by-side frames it wrote."""
    from depth_estimation_tpu_torch.config import CARD
    from depth_estimation_tpu_torch.geometry.face import FaceDet
    from depth_estimation_tpu_torch.runtime.stream import FusedVidStream
    from depth_estimation_tpu_torch.runtime.video import FrameSink

    class Keep(FrameSink):
        def __init__(self):
            self.frames = []

        def write(self, frame):
            self.frames.append(frame.copy())

    detector.face = face = FaceDet(20, np.array(CARD))
    sink = Keep()
    vs = FusedVidStream(estimator, detector, face, src=SyntheticSource(8, 48, 64), output=sink, verbose=False,
                        microbatch=4)
    vs.stream()
    return vs, sink.frames


def test_fused_stream_spans(tiny_estimator, fused_detector):
    """Each tick reads, dispatches (the program inside: upload, the depth
    branch's K2, network and K3, then the face, mesh, outputs and pose
    stages) and fetches; each frame's host half is one ``stream.host_frame``
    holding the route it took, counted as ``route_counts`` counts them."""
    with tracing.record() as spans:
        vs, _ = _fused_stream(tiny_estimator, fused_detector)
    assert vs.route_counts == {"iris": 3, "body": 5}  # both routes run
    by_id = {s.span_id: s for s in spans}
    programs = sorted((s for s in spans if s.name == "program"), key=lambda s: s.start)
    assert len(programs) == 2 and all(p.ids == {"rows": 4} for p in programs)
    for first, p in zip((0, 4), programs):
        children = sorted((s for s in spans if s.parent_id == p.span_id), key=lambda s: s.start)
        assert [s.name for s in children] == ["program.upload", "program.k2", "program.network", "program.k3",
                                              "program.face", "program.mesh", "program.outputs", "program.pose"]
        dispatch = by_id[p.parent_id]
        assert dispatch.name == "stream.dispatch" and dispatch.ids == {"frame": first, "rows": 4}
        fetch = [s for s in spans if s.name == "stream.fetch" and s.ids["frame"] == first]
        assert len(fetch) == 1 and fetch[0].start >= dispatch.end and fetch[0].ids["rows"] == 4
    frames = sorted((s for s in spans if s.name == "stream.host_frame"), key=lambda s: s.start)
    assert [s.ids["frame"] for s in frames] == list(range(8))
    routes = {}
    for s in spans:
        if s.name in ("stream.iris_path", "stream.body_path"):
            parent = by_id[s.parent_id]
            assert parent.name == "stream.host_frame" and parent.start <= s.start <= s.end <= parent.end
            routes[s.name] = routes.get(s.name, 0) + 1
    assert routes == {"stream.iris_path": vs.route_counts["iris"], "stream.body_path": vs.route_counts["body"]}
    assert sum(1 for s in spans if s.name == "stream.read" and s.ids["rows"] == 4) == 3  # the last finds the end


def test_fused_stream_records_nothing_when_off(tiny_estimator, fused_detector, monkeypatch):
    """Off, no span object is made anywhere on the fused path, and the
    frames written are bitwise those of a recorded run."""
    with tracing.record():
        recorded, written_on = _fused_stream(tiny_estimator, fused_detector)

    def refused(*args, **kwargs):
        raise AssertionError("a span was made with recording off")
    monkeypatch.setattr(tracing, "_On", refused)
    plain, written_off = _fused_stream(tiny_estimator, fused_detector)
    assert plain.route_counts == recorded.route_counts
    assert len(written_off) == len(written_on) == 8
    for a, b in zip(written_on, written_off):
        np.testing.assert_array_equal(a, b)
