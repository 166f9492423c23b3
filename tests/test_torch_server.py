"""The port's online servers (``runtime/server.py``) against the JAX
package's on the CPU, on the same weights: a tiny DPT registered in both
registries and, for the fused server, the detector nets through
``params_from_jax_*``. Then the servers' behaviour with stand-in programs
(JAX ``tests/test_server.py``), and the two thread-safety repairs the
servers rest on: the frame program's numerics contexts (``device.py``) and
the kernels' first-use build (``ops/kernels/build.py``).

Tolerances are each helper's: u8 bytes by the u8 rule of
tests/test_torch_estimator.py, f32 maps max-scaled 1e-4, fused outputs by
``assert_frame_agrees`` of tests/test_torch_fused.py.
"""

import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import DPT_PREPROCESS as JAX_DPT_PREPROCESS
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.runtime import fused as jfused
from depth_estimation_tpu.runtime import server as jserver
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, full_f32
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.ops.kernels import build
from depth_estimation_tpu_torch.runtime.fused import FusedFrameRunner
from depth_estimation_tpu_torch.runtime.server import BucketedDepthServer, DepthServer, FusedDepthServer
from depth_estimation_tpu_torch.runtime.video import SyntheticSource
from depth_estimation_tpu_torch.utils.convert import params_from_jax
from tests.oracles import dpt_torch as oracle
from tests.test_torch_detect import detector_pair, detector_trees
from tests.test_torch_dpt import JAX_TINY, TINY
from tests.test_torch_estimator import _assert_u8_agrees
from tests.test_torch_fused import MIXED, assert_frame_agrees, jax_float_mesh_fn

NAME = "DPT_Tiny_server_test"
H, W = 120, 160
SMALL = (64, 96)
TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads a worker: the suite runs six workers on one host."""
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


def _frames(rng, n, hw=(H, W)):
    return [rng.integers(0, 256, (*hw, 3), np.uint8) for _ in range(n)]


def _submit_all(srv, frames):
    futs = [srv.submit(f) for f in frames]
    return [f.result(timeout=TIMEOUT) for f in futs]


def _assert_depth_agrees(got, want, ref, frame, output):
    if output == "u8":
        _assert_u8_agrees(got, want, ref.predict(frame))
    else:
        assert got.dtype == np.float32 and got.shape == want.shape
        scale = np.abs(want).max() + 1e-8
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


# -- against the JAX servers ----------------------------------------------------------


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_depth_server_matches_jax(estimators, rng, output):
    """Six requests at max_batch 4 through both packages' DepthServer: each
    result a host copy of its frame's map, agreeing with JAX's; fewer
    dispatches than requests."""
    ref, port = estimators
    frames = _frames(rng, 6)
    with jserver.DepthServer(ref, (H, W), max_batch=4, max_delay_ms=50, output=output) as jsrv:
        want = _submit_all(jsrv, frames)
    with DepthServer(port, (H, W), max_batch=4, max_delay_ms=50, output=output) as srv:
        got = _submit_all(srv, frames)
    assert srv.frames_served == jsrv.frames_served == 6
    assert srv.batches_dispatched < 6  # loose: a loaded host may preempt the submits
    for frame, g, w in zip(frames, got, want):
        assert isinstance(g, np.ndarray) and g.base is None  # a copy, not a view of the batch
        _assert_depth_agrees(g, np.asarray(w), ref, frame, output)


def test_depth_server_coalesces_concurrent_clients(estimators, rng):
    """Twelve client threads submitting at once coalesce into fewer
    dispatches than requests; each result equals the port's own frame
    program on a batch of max_batch."""
    _, port = estimators
    n = 12
    frames = _frames(rng, n)
    srv = DepthServer(port, (H, W), max_batch=8, max_delay_ms=100)
    srv.warm()
    results = [None] * n
    start = threading.Barrier(n)

    def client(i):
        start.wait()
        results[i] = srv.submit(frames[i]).result(timeout=TIMEOUT)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    srv.close()
    fn = port._batched_fn((H, W), "u8")
    want = np.concatenate([fn(np.stack(frames[i:i + 8] + [frames[i]] * (8 - len(frames[i:i + 8])))).numpy()
                           for i in (0, 8)])
    for i in range(n):
        np.testing.assert_array_equal(results[i], want[i])
    assert srv.frames_served == 1 + n and srv.batches_dispatched < 1 + n


def test_bucketed_server_matches_jax(estimators, rng):
    """Two resolutions from interleaved client threads, so two dispatcher
    threads run frame programs at once; every result agrees with JAX's
    BucketedDepthServer's, bucket stats match, a closed server refuses."""
    ref, port = estimators
    big, small = _frames(rng, 4), _frames(rng, 3, SMALL)
    order = [f for pair in zip(big, small + [None]) for f in pair if f is not None]
    with jserver.BucketedDepthServer(ref, max_batch=4, max_delay_ms=20) as jsrv:
        want = _submit_all(jsrv, order)
    got = [None] * len(order)
    with BucketedDepthServer(port, max_batch=4, max_delay_ms=20) as srv:
        start = threading.Barrier(2)

        def client(parity):
            start.wait()
            for i in range(parity, len(order), 2):
                got[i] = srv.submit(order[i]).result(timeout=TIMEOUT)

        threads = [threading.Thread(target=client, args=(p,)) for p in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        with pytest.raises(ValueError, match="uint8"):
            srv.submit(np.zeros((8, 8, 3), np.float32))
    for frame, g, w in zip(order, got, want):
        assert g.shape == frame.shape[:2]
        _assert_u8_agrees(g, np.asarray(w), ref.predict(frame))
    assert set(srv.stats) == set(jsrv.stats) == {(H, W), SMALL}
    assert {hw: frames for hw, (_, frames) in srv.stats.items()} == {(H, W): 4, SMALL: 3}
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(big[0])


def test_fused_server_matches_jax(estimators, trees, rng):
    """Three requests, two hits and a miss, at max_batch 2 through both
    packages' FusedDepthServer: the same keys (no ``depth``), each dict
    agreeing with JAX's by ``assert_frame_agrees`` (depth maps from each
    package's runner with the map emitted), ``vis_u8`` a uint8 host copy."""
    ref, port = estimators
    src = SyntheticSource(5, H, W)
    frames = [src.read()[1] for _ in range(5)][2:]  # frames 3 and 4 hit at MIXED, 5 misses
    jdet, tdet = detector_pair(trees, MIXED)
    with jserver.FusedDepthServer(ref, jdet, (H, W), max_batch=2, max_delay_ms=50) as jsrv:
        want = _submit_all(jsrv, frames)
    with FusedDepthServer(port, tdet, (H, W), max_batch=2, max_delay_ms=50) as srv:
        got = _submit_all(srv, frames)
    assert srv.frames_served == 3
    jdepth = np.asarray(jfused.FusedFrameRunner(ref, jdet).batched(np.stack(frames))["depth"])
    tdepth = FusedFrameRunner(port, tdet).batched(np.stack(frames))["depth"].numpy()
    float_mesh = jax_float_mesh_fn(jdet)
    hits = []
    for i, frame in enumerate(frames):
        assert set(got[i]) == set(want[i]) and "depth" not in got[i]
        assert got[i]["vis_u8"].dtype == np.uint8 and got[i]["vis_u8"].shape == (H, W)
        w = {k: np.asarray(v) for k, v in want[i].items()}
        hits.append(bool(w["valid"][0]))
        flt = float_mesh(frame, w["boxes"]) if hits[-1] else None
        assert_frame_agrees({**got[i], "depth": tdepth[i]}, {**w, "depth": jdepth[i]}, flt)
    assert hits == [True, True, False]


@pytest.fixture(scope="module")
def trees():
    return detector_trees()


# -- behaviour, with stand-ins ---------------------------------------------------------


def test_server_validates_and_closes(estimators, rng):
    _, port = estimators
    srv = DepthServer(port, (H, W), max_batch=2, max_delay_ms=1)
    with pytest.raises(ValueError, match="uint8"):
        srv.submit(np.zeros((H, W, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        srv.submit(np.zeros((32, 48, 3), np.uint8))
    f = srv.submit(_frames(rng, 1)[0])
    srv.close()
    assert f.result(timeout=TIMEOUT).shape == (H, W)  # served before the shutdown
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_frames(rng, 1)[0])
    srv.close()  # idempotent


class _SlowStandIn:
    """A frame program that takes 0.2 s, so queued requests can be cancelled
    while the dispatcher is busy."""

    def _batched_fn(self, hw, output="u8"):
        def fn(batch):
            time.sleep(0.2)
            return torch.from_numpy(batch[..., 0])

        return fn


def test_server_survives_cancelled_requests(rng):
    frames = _frames(rng, 3, (16, 24))
    srv = DepthServer(_SlowStandIn(), (16, 24), max_batch=1, max_delay_ms=0)
    f1 = srv.submit(frames[0])  # the dispatcher is busy for 0.2 s
    time.sleep(0.05)
    f2 = srv.submit(frames[1])  # queued behind f1
    assert f2.cancel()
    f3 = srv.submit(frames[2])  # still served
    np.testing.assert_array_equal(f1.result(timeout=30), frames[0][..., 0])
    np.testing.assert_array_equal(f3.result(timeout=30), frames[2][..., 0])
    assert f2.cancelled() and srv.frames_served == 2
    srv.close()


class _FailingStandIn:
    def _batched_fn(self, hw, output="u8"):
        def fn(batch):
            raise RuntimeError("boom")

        return fn


def test_server_surfaces_dispatch_errors(rng):
    """A failing program fails every waiting future and leaves the
    dispatcher serving."""
    srv = DepthServer(_FailingStandIn(), (8, 12), max_batch=2, max_delay_ms=20)
    frame = _frames(rng, 1, (8, 12))[0]
    futs = [srv.submit(frame), srv.submit(frame)]
    for fut in futs:
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    with pytest.raises(RuntimeError, match="boom"):  # still serving
        srv.submit(frame).result(timeout=30)
    assert srv.frames_served == 0 and srv._thread.is_alive()
    srv.close()
    assert not srv._thread.is_alive()


def test_bucketed_server_caps_buckets(rng):
    with BucketedDepthServer(_SlowStandIn(), max_batch=2, max_delay_ms=1, max_buckets=1) as srv:
        srv.warm((16, 24))
        with pytest.raises(ValueError, match="max_buckets"):
            srv.submit(_frames(rng, 1, (8, 12))[0])
        assert srv.stats == {(16, 24): (1, 1)}


def test_fused_server_rejects_incapable_detector(estimators):
    class _NotADetector:
        pass

    with pytest.raises(ValueError, match="fused-capable"):
        FusedDepthServer(estimators[1], _NotADetector(), (H, W))


# -- the thread-safety repairs ---------------------------------------------------------


def _tf32():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _set_tf32(flags):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _benchmark():
    return torch.backends.cudnn.benchmark


def _set_benchmark(flag):
    torch.backends.cudnn.benchmark = flag


@pytest.mark.parametrize("ctx,read,write,outside,inside", [
    (full_f32, _tf32, _set_tf32, (True, True), (False, False)),
    (conv_algorithms_by_timing, _benchmark, _set_benchmark, False, True),
], ids=["full_f32", "conv_algorithms_by_timing"])
def test_numerics_contexts_hold_across_threads(ctx, read, write, outside, inside):
    """Thread A enters, thread B enters, A leaves: B still reads the
    program's flags; after both leave, the flags read as before A entered."""
    saved = read()
    write(outside)
    events = {k: threading.Event() for k in ("a_in", "b_in", "a_out")}
    seen = {}

    def a():
        with ctx():
            events["a_in"].set()
            events["b_in"].wait(10)
        events["a_out"].set()

    def b():
        events["a_in"].wait(10)
        with ctx():
            events["b_in"].set()
            events["a_out"].wait(10)
            seen["b_after_a_left"] = read()

    try:
        threads = [threading.Thread(target=a), threading.Thread(target=b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert all(e.is_set() for e in events.values())
        assert seen == {"b_after_a_left": inside}
        assert read() == outside
    finally:
        write(saved)


class _FakeNvcc:
    """``subprocess.Popen`` for nvcc: records the source, writes the output
    file after a short compile."""

    compiled = []
    lock = threading.Lock()

    def __init__(self, cmd, **kwargs):
        with self.lock:
            self.compiled.append(cmd[-1])
        self._out = cmd[cmd.index("-o") + 1]
        self.returncode = None
        time.sleep(0.02)

    def communicate(self):
        time.sleep(0.05)
        with open(self._out, "w") as f:
            f.write("library")
        self.returncode = 0
        return "ptxas info    : Used 32 registers", None

    def poll(self):
        return self.returncode


def test_concurrent_first_use_builds_each_source_once(tmp_path, monkeypatch):
    """Eight threads reach every kernel's first use together: each source is
    compiled once, no temporary file is left, and every thread gets the one
    library object of each source."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("library", path))
    _FakeNvcc.compiled = []
    libs, errors = [], []
    start = threading.Barrier(8)

    def first_use(i):
        try:
            start.wait()
            names = build.SOURCES[i % 3:] + build.SOURCES[:i % 3]
            if i % 2:
                build.build(names)
            libs.append({name: build.load(name) for name in names})
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sorted(_FakeNvcc.compiled) == sorted(str(build.CSRC / f"{n}.cu") for n in build.SOURCES)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(build.library_path(n).name for n in build.SOURCES)
    assert len(libs) == 8 and all(lib == libs[0] for lib in libs)
    assert all(libs[0][n] is lib[n] for lib in libs for n in build.SOURCES)
