"""The port's DepthEstimator and VidStream against the JAX package's, on the
same weights (tiny DPT registered in both registries), on the CPU."""

import warnings

import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import DPT_PREPROCESS as JAX_DPT_PREPROCESS
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.runtime.stream import VidStream as JaxVidStream
from depth_estimation_tpu.runtime.video import NullSink as JaxNullSink
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.runtime.stream import VidStream
from depth_estimation_tpu_torch.runtime.video import NullSink, SyntheticSource
from depth_estimation_tpu_torch.utils.convert import params_from_jax
from tests.oracles import dpt_torch as oracle
from tests.test_torch_dpt import JAX_TINY, TINY

NAME = "DPT_Tiny_port_test"
H, W = 120, 160


@pytest.fixture(scope="module")
def estimators():
    jreg.register(jreg.ModelEntry(NAME, lambda: JaxDPT(JAX_TINY), JAX_DPT_PREPROCESS,
                                  lambda sd: convert_dpt(sd, JAX_TINY)))
    treg.register(treg.ModelEntry(NAME, lambda: DPT(TINY), DPT_PREPROCESS))
    hub_sd = {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY, seed=3).items()}
    # depth up to ~80 (and bicubic undershoot below 0, which wraps), so the u8
    # bytes carry information while the two packages' f32 maps stay within
    # the 1e-3 that the u8 rule allows
    for k in ("scratch.output_conv.4.weight", "scratch.output_conv.4.bias"):
        hub_sd[k] = hub_sd[k] * 50
    jax_params = convert_dpt(hub_sd, JAX_TINY)
    ref = JaxEstimator(NAME, params=jax_params, verbose=False)
    port = DepthEstimator(NAME, params=params_from_jax(jax_params, TINY), verbose=False, device="cpu")
    return ref, port


def _collector(sink_cls):
    """A sink of either package that keeps every frame written to it."""

    class Collect(sink_cls):
        def __init__(self):
            super().__init__()
            self.frames = []

        def write(self, frame):
            super().write(frame)
            self.frames.append(np.asarray(frame).copy())

    return Collect()


def _assert_u8_agrees(got, want, f32):
    """Bytes may differ only where the f32 map lies within 1e-3 of an
    integer, where the two packages' rounding can truncate differently."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differ = got != want
    near_int = np.abs(f32 - np.round(f32)) < 1e-3
    assert not (differ & ~near_int).any(), f"{int((differ & ~near_int).sum())} bytes differ away from an integer"


def _frames(n):
    src = SyntheticSource(n, H, W)
    return [src.read()[1] for _ in range(n)]


def test_predict_matches_jax(rng, estimators):
    ref, port = estimators
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    want, got = ref.predict(img), port.predict(img)
    assert got.shape == want.shape == (H, W) and got.dtype == np.float32
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_predict_device_u8_matches_jax(rng, estimators):
    ref, port = estimators
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    got = port.predict_device_u8(img)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _assert_u8_agrees(got.numpy(), np.asarray(ref.predict_device_u8(img)), ref.predict(img))


def test_predict_batch_matches_jax(rng, estimators):
    ref, port = estimators
    imgs = rng.integers(0, 256, (2, H, W, 3), np.uint8)
    want, got = ref.predict_batch(imgs), port.predict_batch(imgs)
    assert got.shape == want.shape == (2, H, W)
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


@pytest.mark.parametrize("microbatch", [1, 3])
def test_vidstream_frames_match_jax(estimators, microbatch):
    ref, port = estimators
    want, got = _collector(JaxNullSink), _collector(NullSink)
    JaxVidStream(ref, "synthetic:6x120x160", want, verbose=False, microbatch=microbatch).update()
    vs = VidStream(port, "synthetic:6x120x160", got, verbose=False, microbatch=microbatch)
    vs.update()
    assert len(got.frames) == len(want.frames) == 6
    assert len(vs.timer.performance["depth"]) == 6
    for frame, g, w in zip(_frames(6), got.frames, want.frames):
        assert g.shape == (H, W, 3)
        _assert_u8_agrees(g, w, np.repeat(ref.predict(frame)[..., None], 3, axis=-1))


def test_bfloat16_estimator_close_to_f32(rng, estimators):
    _, port = estimators
    e16 = DepthEstimator(NAME, params=port.model.state_dict(), dtype="bfloat16", verbose=False, device="cpu")
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    d32, d16 = port.predict(img), e16.predict(img)
    assert d16.dtype == np.float32  # the map always comes back in f32
    assert np.abs(d32 - d16).max() / np.abs(d32).max() < 0.05


def test_frame_program_numerics_set_and_restore_flags(estimators):
    """f32 programs run without TF32; programs of either type let cuDNN pick
    each conv's algorithm by timing (MiDaS at batch 4 fell to a slow FFT
    under the heuristic); the flags are restored on exit."""
    _, port = estimators
    e16 = DepthEstimator(NAME, params=port.model.state_dict(), dtype="bfloat16", verbose=False, device="cpu")

    def flags():
        return (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    before = flags()
    with port._numerics():
        assert flags() == (True, False, False)
    assert flags() == before
    with e16._numerics():
        assert flags() == (True, *before[1:])
    assert flags() == before


def test_vidstream_prints_reference_frames(estimators, capsys):
    _, port = estimators
    sink = NullSink()
    VidStream(port, SyntheticSource(3, H, W), sink, verbose=True, start_frame=1).update()
    assert sink.frames_written == 2
    assert "Frame: 3" in capsys.readouterr().out


def test_refuses_cuda_without_gpu(estimators):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DepthEstimator(NAME, verbose=False)  # device defaults to cuda


def test_random_init_warns_and_is_seeded(estimators):
    with pytest.warns(UserWarning, match="random"):
        a = DepthEstimator(NAME, seed=1, verbose=False, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = DepthEstimator(NAME, seed=1, verbose=False, device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_model_type_errors():
    with pytest.raises(ValueError, match="unknown model_type"):
        DepthEstimator("NoSuchModel", verbose=False, device="cpu")


def test_synthetic_source_byte_identical_to_jax():
    from depth_estimation_tpu.runtime.video import open_source as jax_open_source
    from depth_estimation_tpu_torch.runtime.video import open_source

    a, b = open_source("synthetic:9x48x64"), jax_open_source("synthetic:9x48x64", prefer_native=False)
    assert (a.frame_count, a.height, a.width) == (b.frame_count, b.height, b.width)
    for _ in range(10):
        (oka, fa), (okb, fb) = a.read(), b.read()
        assert oka == okb
        if oka:
            np.testing.assert_array_equal(fa, fb)


class _FlakySource(SyntheticSource):
    """read() raises at the given frame indices, as a corrupt packet does."""

    def __init__(self, n, fail_at):
        super().__init__(n, 32, 48)
        self.fail_at = set(fail_at)

    def read(self):
        idx = self._i
        ok, frame = super().read()
        if ok and idx in self.fail_at:
            raise RuntimeError(f"injected decode failure at frame {idx}")
        return ok, frame


def test_stream_skips_undecodable_frames_and_logs(estimators, tmp_path, monkeypatch, capsys):
    import json

    _, port = estimators
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("DEPTH_TPU_LOG_JSON", str(log))
    sink = NullSink()
    VidStream(port, _FlakySource(6, fail_at=(1, 4)), sink, microbatch=2).update()
    assert sink.frames_written == 4
    assert "Dropped 2 undecodable frames." in capsys.readouterr().out
    end = json.loads(log.read_text().splitlines()[-1])
    assert end["event"] == "stream_end" and end["frames_dropped"] == 2 and end["frames"] == 4
