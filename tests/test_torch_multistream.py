"""The port's ``MultiStream`` and ``tools/serve.py`` against the JAX
package's on the CPU: the tiny DPT registered in both registries for the
stream fleets (frames by the u8 rule of tests/test_torch_estimator.py, and
equal to the port's own frame program driven as JAX's test drives it), and
``MiDaS_small`` for the ``serve`` CLI, whose printed lines must be JAX's."""

import contextlib
import io
import re
import warnings

import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import DPT_PREPROCESS as JAX_DPT_PREPROCESS
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.runtime.multistream import MultiStream as JaxMultiStream
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu.tools import serve as jserve
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.ops.postprocess import merge_gray3
from depth_estimation_tpu_torch.runtime.multistream import MultiStream
from depth_estimation_tpu_torch.runtime.video import NullSink, SyntheticSource
from depth_estimation_tpu_torch.tools import serve
from depth_estimation_tpu_torch.utils.convert import params_from_jax
from tests.oracles import dpt_torch as oracle
from tests.test_torch_dpt import JAX_TINY, TINY
from tests.test_torch_estimator import _assert_u8_agrees, _collector

NAME = "DPT_Tiny_multistream_test"


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


def drive(est, specs, hw, M):
    """JAX tests/test_multistream.py's reference loop on the port's frame program: up
    to M frames a live stream a tick into a (K·M, …) batch, short slots
    padded with their last frame, valid results demuxed a stream."""
    fn = est._batched_fn(hw, output="u8")
    sources = [SyntheticSource.from_spec(s) for s in specs]
    K = len(sources)
    batch = np.zeros((K * M, *hw, 3), np.uint8)
    alive = [True] * K
    expected = [[] for _ in sources]
    while any(alive):
        valid = []
        for i, s in enumerate(sources):
            m = 0
            if alive[i]:
                while m < M:
                    ok, f = s.read()
                    if not ok:
                        alive[i] = False
                        break
                    batch[i * M + m] = f
                    m += 1
            if 0 < m < M:
                batch[i * M + m:(i + 1) * M] = batch[i * M + m - 1]
            valid.append(m)
        if not any(valid):
            break
        preds = fn(batch).numpy()
        for i, m in enumerate(valid):
            expected[i].extend(merge_gray3(preds[i * M + j]) for j in range(m))
    return expected


def _run_both(estimators, specs, M):
    ref, port = estimators
    jsinks, tsinks = [_collector(JaxNullSink) for _ in specs], [_collector(NullSink) for _ in specs]
    jms = JaxMultiStream(ref, specs, jsinks, verbose=False, microbatch=M)
    jms.run()
    ms = MultiStream(port, specs, tsinks, verbose=False, microbatch=M)
    ms.run()
    return jms, ms, jsinks, tsinks


def _assert_fleet_agrees(estimators, specs, jsinks, tsinks, expected):
    ref, _ = estimators
    for spec, jsink, tsink, exp in zip(specs, jsinks, tsinks, expected):
        src = SyntheticSource.from_spec(spec)
        frames = [src.read()[1] for _ in range(src.n)]
        assert len(tsink.frames) == len(jsink.frames) == len(exp) == len(frames)
        for frame, g, w, e in zip(frames, tsink.frames, jsink.frames, exp):
            np.testing.assert_array_equal(g, e)
            _assert_u8_agrees(g, w, np.repeat(ref.predict(frame)[..., None], 3, axis=-1))


@pytest.mark.parametrize("M", [1, 2])
def test_mixed_resolution_fleet_matches_jax(estimators, M):
    """Two resolution buckets: every stream's frames in order, agreeing with
    JAX's fleet and equal to each bucket driven as a uniform fleet; the same
    counts, buckets and completion spans (one a tick)."""
    specs = ["synthetic:3x120x160", "synthetic:2x64x96", "synthetic:4x120x160"]
    jms, ms, jsinks, tsinks = _run_both(estimators, specs, M)
    assert ms.counts == jms.counts == [3, 2, 4]
    assert list(ms.buckets.items()) == list(jms.buckets.items()) == [((120, 160), [0, 2]), ((64, 96), [1])]
    assert len(ms.timer.performance["depth"]) == len(jms.timer.performance["depth"])
    port = estimators[1]
    a, b = drive(port, [specs[0], specs[2]], (120, 160), M), drive(port, [specs[1]], (64, 96), M)
    _assert_fleet_agrees(estimators, specs, jsinks, tsinks, [a[0], b[0], a[1]])


def test_microbatch_with_streams_ending_mid_tick_matches_jax(estimators):
    """microbatch=2 over streams of 5, 3 and 1 frames (ending mid-tick, one
    shorter than a tick): the same frames in the same order as JAX's."""
    specs = ["synthetic:5x120x160", "synthetic:3x120x160", "synthetic:1x120x160"]
    jms, ms, jsinks, tsinks = _run_both(estimators, specs, 2)
    assert ms.counts == jms.counts == [5, 3, 1]
    assert len(ms.timer.performance["depth"]) == len(jms.timer.performance["depth"]) == 3
    _assert_fleet_agrees(estimators, specs, jsinks, tsinks, drive(estimators[1], specs, (120, 160), 2))


def test_prints_jax_lines(estimators, capsys):
    """verbose=True prints JAX's tick and end lines (the FPS figure aside)."""
    ref, port = estimators
    specs = ["synthetic:2x64x96", "synthetic:1x64x96"]
    out = []
    for cls, est in ((JaxMultiStream, ref), (MultiStream, port)):
        cls(est, specs, verbose=True).run()
        out.append(re.sub(r"Depth: \S+", "Depth: N", capsys.readouterr().out))
    assert out[1] == out[0]
    assert "Tick: 2 (1/2 live)" in out[1] and "Sucessfully read 3 frames over 2 streams." in out[1]


def test_rejects_bad_configs(estimators):
    port = estimators[1]
    with pytest.raises(ValueError, match="at least one"):
        MultiStream(port, [])
    with pytest.raises(ValueError, match="outputs"):
        MultiStream(port, [SyntheticSource(2, 64, 96)], outputs=[None, None])


def _cli_lines(main, argv):
    """``main(argv)``'s standard output, with the run's timing and dispatch
    counts (which vary from run to run) replaced by N."""
    buf = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(buf):
        warnings.simplefilter("ignore")
        main(argv)
    out = re.sub(r"Depth: \S+", "Depth: N", buf.getvalue())
    return re.sub(r"requests in \d+ dispatches", "requests in N dispatches", out).splitlines()


@pytest.mark.parametrize("mode", [[], ["--online", "--max-batch", "4", "--max-delay-ms", "50"]],
                         ids=["multistream", "online"])
def test_serve_cli_prints_jax_lines(mode):
    """``serve`` over three streams at two resolutions (MiDaS_small, random
    weights): the port on ``--device cpu`` prints JAX's lines."""
    argv = ["--src", "synthetic:4x64x96", "--src", "synthetic:3x64x96", "--src", "synthetic:2x32x48", *mode]
    want = _cli_lines(jserve.main, argv)
    got = _cli_lines(serve.main, [*argv, "--device", "cpu"])
    assert got == want
    assert "Sucessfully read 9 frames over 3 streams." in got
    if mode:
        assert "Online: 9 requests in N dispatches across 2 resolution bucket(s) (max_batch 4)" in got


def test_serve_cli_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve.main(["--src", "synthetic:1x32x48"])
