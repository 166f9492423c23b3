"""The reference against the program's CPU path at a tiny size, on the
benchmark's weights; the reference's architecture against the program's
for the benchmark's own configurations; the comparison numbers."""

import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import compare
from portbench.frames import Frames
from portbench.reference import frame as ref
from portbench.reference import family
from portbench.weights import make_weights
from portbench.tests.conftest import register_tiny, tiny_config

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("name", ["dpt_large", "dpt_hybrid"])
def test_reference_holds_the_programs_state_dict_and_sizes(name):
    from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
    from depth_estimation_tpu_torch.registry import get_entry

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    entry = get_entry(cfg["model_type"])
    with torch.device("meta"):
        port, mine = entry.make_model(), family(cfg).build(cfg)
    theirs = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    ours = {k: tuple(v.shape) for k, v in mine.state_dict().items()}
    assert ours == theirs
    assert list(compute_resize_shape(*cfg["input_hw"], entry.preprocess)) == cfg["net_hw"]
    assert list(entry.preprocess.mean) == cfg["preprocess"]["mean"]
    assert list(entry.preprocess.std) == cfg["preprocess"]["std"]


@pytest.mark.parametrize("name", ["dpt_large", "dpt_hybrid"])
@pytest.mark.parametrize("output", ["f32", "u8"])
def test_reference_matches_the_programs_cpu_path(name, output):
    from depth_estimation_tpu_torch.estimator import DepthEstimator

    torch.set_num_threads(2)
    cfg = tiny_config(name)
    register_tiny(cfg)
    est = DepthEstimator(cfg["model_type"], params=make_weights(cfg, 7, "cpu"), device="cpu", verbose=False)
    frames = Frames(7, cfg["input_hw"], "cpu").stack([0, 1, 2])
    got = est._batched_fn(frames.shape[1:3], output)(frames)
    want = ref.depth_maps(ref.build_model(cfg, make_weights(cfg, 7, "cpu"), "cpu"), torch.from_numpy(frames), cfg)
    assert want.abs().amax() > 20  # the head's gain makes maps a u8 cast can tell apart
    # the hybrid's stem lifts f32 rounding: each side's network output lies
    # about 5e-5 from its float64 value at this size; the port's gate is 1e-3
    tol = 1e-3 if cfg["is_hybrid"] else 2e-4
    for g, w in zip(got, want):
        err = compare.u8_gap(g, w) if output == "u8" else compare.max_scaled_err(g, w)
        assert err < tol, err


def test_weights_are_the_same_for_a_seed_and_differ_between_seeds():
    cfg = tiny_config("dpt_large")
    a, b, c = (make_weights(cfg, s, "cpu") for s in (2 ** 31 + 5, 2 ** 31 + 5, 3))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pretrained.model.blocks.0.attn.qkv.weight"], c["pretrained.model.blocks.0.attn.qkv.weight"])


def test_frames_are_all_distinct_and_rebuilt_from_the_seed():
    f = Frames(11, (48, 64), "cpu")
    stack = f.stack(range(40))
    assert len({x.tobytes() for x in stack}) == 40
    assert np.array_equal(Frames(11, (48, 64), "cpu").frame(33), stack[33])


def test_u8_gap_reads_zero_for_the_references_own_cast_and_the_distance_otherwise():
    want = torch.tensor([[0.5, 255.9, 256.2, 700.0, -0.4, -1.5]], dtype=torch.float32)
    own = ref.wraparound_u8(want)
    assert own.tolist() == [[0, 255, 0, 188, 0, 255]]
    assert compare.u8_gap(own, want) == 0.0
    rounded = own.clone()
    rounded[0, 2] = 255  # 256.2 read as 255.99...: a rounding across an integer
    assert compare.u8_gap(rounded, want) == pytest.approx(0.2 / 700.0, rel=1e-4)  # 256.2 in f32
    wrong = own.clone()
    wrong[0, 3] = 100  # 700 -> 612 or 868 would give 100
    assert compare.u8_gap(wrong, want) == pytest.approx(87.0 / 700.0, rel=1e-3)


def test_max_scaled_err():
    want = torch.tensor([1.0, -4.0, 2.0])
    assert compare.max_scaled_err(want + torch.tensor([0.0, 0.0, 0.04]), want) == pytest.approx(0.01)
