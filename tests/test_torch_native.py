"""The port's native framepipe (``runtime/native.py``, ``native/framepipe.cpp``)
against the JAX package's, the counterpart of tests/test_native.py: the
synthetic source byte-equal to JAX's, the borrow protocol, files crossing
between the two packages' writers and readers, the preference of
``open_source`` / ``open_sink``, ``needs_prefetch``, a ``VidStream`` on
either source, and the build without OpenCV."""

import time

import numpy as np
import pytest
import torch

from depth_estimation_tpu.runtime import native as jax_native
from depth_estimation_tpu.runtime.video import SyntheticSource as JaxSyntheticSource
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.estimator import DepthEstimator, random_state_dict
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.runtime import native
from depth_estimation_tpu_torch.runtime.stream import VidStream
from depth_estimation_tpu_torch.runtime.video import (NullSink, OpenCVSink, OpenCVSource, PrefetchSource,
                                                      SyntheticSource, needs_prefetch, open_sink, open_source)
from tests.test_torch_dpt import TINY
from tests.test_torch_estimator import _collector


@pytest.fixture(autouse=True)
def _native_library():
    """tests/test_native.py's condition, decided when a test runs: the library builds."""
    if not native.native_available():
        pytest.skip(f"the port's native framepipe cannot build: {native.native_load_error()}")


def _frames(source):
    out = []
    while True:
        ok, frame = source.read()
        if not ok:
            return out
        out.append(frame)


@pytest.mark.parametrize("n_frames", [6, 200])  # 200 wraps the depth-4 ring many times
def test_native_synthetic_matches_jax_synthetic(n_frames):
    ns = native.NativeSource(f"synthetic:{n_frames}x48x64")
    assert (ns.width, ns.height, ns.frame_count) == (64, 48, float(n_frames))
    got, want = _frames(ns), _frames(JaxSyntheticSource(n_frames, 48, 64))
    ns.release()
    assert len(got) == len(want) == n_frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_borrow_protocol():
    ns = native.NativeSource("synthetic:3x32x32")
    want = _frames(SyntheticSource(3, 32, 32))
    seen = 0
    while True:
        slot, view = ns.read_borrowed()
        if slot < 0:
            break
        assert view.shape == (32, 32, 3) and view.dtype == np.uint8
        np.testing.assert_array_equal(view, want[seen])
        ns.release_slot(slot)
        seen += 1
    assert seen == 3
    assert ns.read_borrowed() == (-1, None) and ns.read() == (False, None)
    ns.release()


def _write(sink, frames):
    for f in frames:
        sink.write(f)
    for _ in range(200):  # the writer is asynchronous: wait for its queue to drain
        if sink.frames_written() == len(frames):
            break
        time.sleep(0.02)
    assert sink.frames_written() == len(frames)
    sink.release()


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_files_cross_between_the_packages(tmp_path, writer, reader):
    """The port's sink read back by JAX's source, and JAX's sink by the
    port's, each frame within a mean abs of 12 (MJPG is lossy)."""
    if not (native.native_opencv() and jax_native.native_available()):
        pytest.skip(f"no OpenCV build: port {native.native_load_error()}, JAX {jax_native.native_load_error()}")
    packages = {"port": native, "jax": jax_native}
    path = str(tmp_path / "crossed.avi")
    frames = _frames(SyntheticSource(5, 48, 64))
    _write(packages[writer].NativeSink(path, (64, 48), fps=20.0), frames)
    back = packages[reader].NativeSource(path)
    assert back.is_opened() and (back.width, back.height) == (64, 48)
    got = _frames(back)
    back.release()
    assert len(got) == 5
    for g, f in zip(got, frames):
        assert g.shape == (48, 64, 3)
        assert np.abs(g.astype(int) - f.astype(int)).mean() < 12.0


def test_native_missing_file_reports_closed():
    ns = native.NativeSource("/nonexistent/nope.mp4")
    assert not ns.is_opened()
    assert ns.read() == (False, None)


def test_open_source_and_sink_prefer_native(tmp_path):
    s = open_source("synthetic:2x16x16")
    assert isinstance(s, native.NativeSource)
    assert isinstance(open_source("synthetic:2x16x16", prefer_native=False), SyntheticSource)
    if native.native_opencv():
        sink = open_sink(str(tmp_path / "a.avi"), (16, 16))
        assert isinstance(sink, native.NativeSink)
        sink.release()
    sink = open_sink(str(tmp_path / "b.avi"), (16, 16), prefer_native=False)
    assert isinstance(sink, OpenCVSink)
    sink.release()


def test_needs_prefetch_is_false_for_a_native_source():
    assert not needs_prefetch(native.NativeSource("synthetic:2x16x16"))
    assert needs_prefetch(SyntheticSource(2, 16, 16))


NAME = "DPT_Tiny_native_test"


def test_vidstream_gives_the_same_maps_from_either_source():
    """A ``VidStream`` of the tiny DPT on the native source (no Python
    prefetch thread) writes the same u8 maps as on the Python source."""
    treg.register(treg.ModelEntry(NAME, lambda: DPT(TINY), DPT_PREPROCESS))
    with torch.device("meta"):
        meta = DPT(TINY)
    sd = random_state_dict(meta, seed=0)
    for k in ("scratch.output_conv.4.weight", "scratch.output_conv.4.bias"):
        sd[k] = sd[k] * 50  # depth over 1, so that the u8 bytes carry information
    est = DepthEstimator(NAME, params=sd, verbose=False, device="cpu")
    outs = {}
    for kind, src in (("native", "synthetic:5x48x64"), ("python", SyntheticSource(5, 48, 64))):
        sink = _collector(NullSink)
        vs = VidStream(est, src, sink, verbose=False)
        assert isinstance(vs.video, PrefetchSource) == (kind == "python")  # VidStream's Python decode thread
        resilient = vs.video.inner if kind == "python" else vs.video
        assert isinstance(resilient.inner, native.NativeSource if kind == "native" else SyntheticSource)
        vs.update()
        outs[kind] = sink.frames
    assert len(outs["native"]) == len(outs["python"]) == 5
    assert len(np.unique(outs["python"][0])) > 2
    for g, w in zip(outs["native"], outs["python"]):
        np.testing.assert_array_equal(g, w)


def test_the_build_without_opencv_serves_synthetic_frames_and_refuses_files(monkeypatch, tmp_path):
    """The source built with ``-DFRAMEPIPE_NO_OPENCV`` (as where no OpenCV
    headers are found): the ring, decode thread and synthetic source work,
    a video file and the writer are refused, and ``open_source`` /
    ``open_sink`` go on to Python IO for files."""
    lib = native.load((native.NO_OPENCV,))
    assert lib.fp_has_opencv() == 0
    monkeypatch.setitem(native._LIBS, (), lib)
    monkeypatch.setitem(native._NO_OPENCV_WHY, (), f"built with -D{native.NO_OPENCV}")
    assert native.native_available() and not native.native_opencv()
    assert "built without OpenCV" in native.native_load_error()
    src = native.NativeSource("synthetic:7x24x40")
    got = _frames(src)
    src.release()
    want = _frames(SyntheticSource(7, 24, 40))
    assert len(got) == 7 and all(np.array_equal(g, w) for g, w in zip(got, want))
    path = str(tmp_path / "clip.avi")
    writer = OpenCVSink(path, (40, 24))
    for f in want:
        writer.write(f)
    writer.release()
    assert not native.NativeSource(path).is_opened()
    with pytest.raises(RuntimeError, match="no OpenCV"):
        native.NativeSink(str(tmp_path / "x.avi"), (40, 24))
    fallback = open_source(path)
    assert isinstance(fallback, OpenCVSource) and fallback.is_opened()
    fallback.release()
    sink = open_sink(str(tmp_path / "y.avi"), (40, 24))
    assert isinstance(sink, OpenCVSink)
    sink.release()
