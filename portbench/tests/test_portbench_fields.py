"""A configuration of several nets, with several output fields a frame,
several adjusted heads and BatchNorm buffers, added as files and entries
alone (``twonet.py``: a tiny DPT and a tiny SSD-like detector): sound, its
run is correct; a float field altered, a flag flipped far from its
threshold, or an int one past its truncation is not correct, and a flag
flipped within rounding of its threshold is. Also the two comparisons for
discrete outputs, the weights' buffers and heads, and the operation count
of several nets."""

import copy
import hashlib
import json
import sys
import types

import pytest
import torch

from portbench import compare, control, harness, roofline
from portbench import spec as specs
from portbench.reference import frame as ref
from portbench.spec import Spec
from portbench.tests import twonet
from portbench.tests.conftest import register_tiny, tiny_config
from portbench.weights import make_weights

CELL = "twonet.frames6"
SEED = 2 ** 31 + 21
THRESHOLD = 0.0
BAND = 0.02  # the flag's limit: a flip within it is rounding at this test's scale
LIMITS = {"fields": {
    "depth": {"compare": "max_scaled_err", "limit": 3e-4},
    "valid": {"compare": "flag_gap", "limit": BAND, "args": {"threshold": THRESHOLD}},
    "point": {"compare": "trunc_gap", "limit": 1e-3},
    "sample": {"compare": "max_scaled_err", "limit": 3e-4}}}


def twonet_config() -> dict:
    cfg = tiny_config("dpt_large")
    cfg.update(reference="twonet", detector={"net_hw": [16, 16], "channels": 8, "threshold": THRESHOLD})
    cfg["weights"] = {"rule": cfg["weights"]["rule"], "heads": [
        {"param": "depth.scratch.output_conv.4", "gain": 50.0, "bias": 20.0},
        {"param": "det.score", "bias": 0.1}]}
    return cfg


@pytest.fixture(scope="module")
def spec(tiny_spec, tmp_path_factory):
    """A checkout that holds the new configuration's files beside the tiny
    benchmark's, with the family's module found under its name."""
    root = tmp_path_factory.mktemp("twonet_bench")
    pb = root / "portbench"
    for d in ("configs", "traffic", "limits", "drivers"):
        (pb / d).mkdir(parents=True)
    (pb / "metrics").symlink_to(specs.HERE / "metrics")
    cfg = twonet_config()
    register_tiny(cfg)
    (pb / "configs" / "twonet.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "frames6.json").write_text(json.dumps(
        {"driver": "twonet", "frames": 6, "arrivals": {"process": "closed"}}))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    (pb / "drivers" / "twonet.py").write_text("from portbench.tests.twonet import run  # noqa: F401\n")
    bench = copy.deepcopy(tiny_spec.bench)
    for c in bench["configs"]:
        c["file"] = str(tiny_spec.root / c["file"])
    bench["configs"].append({"name": "twonet", "source": "https://arxiv.org/abs/2103.13413",
                             "file": "portbench/configs/twonet.json", "reduced": [], "why": "two nets"})
    bench["workloads"].append({"name": CELL, "config": "twonet", "traffic": "frames6", "chips": 1,
                               "why": "six frames, one at a time"})
    next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(specs, "HERE", pb)
        mp.setitem(sys.modules, "portbench.reference.twonet", twonet)
        yield Spec(root)


def _run(spec):
    return harness.run_cell(spec, CELL, SEED, 0.5, False, device="cpu")


def test_a_sound_run_of_several_fields_is_correct(spec):
    r = _run(spec)
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == ["missing", "compared", "depth.max_scaled_err", "valid.flag_gap",
                                 "point.trunc_gap", "sample.max_scaled_err"]
    assert r["checks"]["compared"]["value"] == 6
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}


def _patch_fields(monkeypatch, change):
    call = twonet.DetectorProgram.__call__

    def broken(self, frames_u8, depth):
        return change(self, call(self, frames_u8, depth))
    monkeypatch.setattr(twonet.DetectorProgram, "__call__", broken)


def _sample_altered(monkeypatch):
    def change(self, out):
        out["sample"] = out["sample"] + torch.nn.functional.one_hot(torch.tensor(0), out["sample"].shape[1])
        return out
    _patch_fields(monkeypatch, change)
    return "sample.max_scaled_err"


def _point_one_past(monkeypatch):
    points = twonet.DetectorProgram.points

    def broken(self, offset):
        return points(self, offset) + 1  # each one past its truncation; the samples follow these points
    monkeypatch.setattr(twonet.DetectorProgram, "points", broken)
    return "point.trunc_gap"


def _flag_flipped_far(monkeypatch):
    flags = twonet.DetectorProgram.flags

    def broken(self, score):
        valid = flags(self, score).clone()
        far = (score - THRESHOLD).abs().argmax(dim=1)
        valid[torch.arange(len(valid)), far] ^= True
        return valid
    monkeypatch.setattr(twonet.DetectorProgram, "flags", broken)
    return "valid.flag_gap"


def _depth_altered(monkeypatch):
    from depth_estimation_tpu_torch.estimator import DepthEstimator

    run = DepthEstimator._run

    def broken(self, imgs, output="f32", model=None):
        out = run(self, imgs, output, model).clone()
        out[0, 3, 5] += 1.0
        return out
    monkeypatch.setattr(DepthEstimator, "_run", broken)
    return "depth.max_scaled_err"


@pytest.mark.parametrize("fault", [_depth_altered, _sample_altered, _flag_flipped_far, _point_one_past])
def test_a_broken_field_is_not_correct(spec, monkeypatch, fault):
    key = fault(monkeypatch)
    r = _run(spec)
    assert not r["correct"], r["checks"]
    failed = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert failed == {key}, r["checks"]  # the stage after a discrete choice follows the program's choice
    if key == "point.trunc_gap":
        assert r["checks"][key]["value"] > 0.9


def test_a_flag_flipped_within_rounding_of_its_threshold_is_correct(spec, monkeypatch):
    flags = twonet.DetectorProgram.flags
    flipped = []

    def near(self, score):
        valid = flags(self, score)
        close = (score - THRESHOLD).abs() < BAND / 2
        flipped.append(int(close.sum()))
        return valid ^ close
    monkeypatch.setattr(twonet.DetectorProgram, "flags", near)
    r = _run(spec)
    assert sum(flipped[1:]) > 0  # flips in the window's frames, after the warm-up's
    assert r["correct"], r["checks"]
    assert 0 < r["checks"]["valid.flag_gap"]["value"] < BAND / 2


def test_the_control_reads_every_field(spec):
    """On the CPU TF32 changes nothing, so the control is the reference
    handed its own choices, and reads 0 in every field."""
    (r,) = control.readings(spec, CELL, [SEED], device="cpu")
    assert r["frames"] == 32 and r["fails"] is False
    assert {k: c["value"] for k, c in r["controls"].items()} == {
        "depth.max_scaled_err": 0.0, "valid.flag_gap": 0.0, "point.trunc_gap": 0.0, "sample.max_scaled_err": 0.0}
    assert r["reference"]["valid"]["min"] < THRESHOLD < r["reference"]["valid"]["max"]  # some hit, some miss


def test_trunc_gap_reads_zero_for_the_references_own_truncation_and_the_distance_otherwise():
    want = torch.tensor([3.25, 0.5, -0.5, -2.75, 7.999])
    own = compare.served("trunc_gap", want)
    assert own.tolist() == [3, 0, 0, -2, 7]
    assert compare.trunc_gap(own, want) == 0.0
    assert compare.trunc_gap(own + torch.tensor([1, 0, 0, 0, 0]), want) == pytest.approx(0.75)
    assert compare.trunc_gap(own + torch.tensor([0, 0, 0, 0, 1]), want) == pytest.approx(0.001, abs=1e-6)
    assert compare.trunc_gap(own - torch.tensor([0, 0, 0, 1, 0]), want) == pytest.approx(0.25)
    assert compare.trunc_gap(own + torch.tensor([0, 0, 0, 0, 4]), want) == pytest.approx(3.001, abs=1e-6)


def test_flag_gap_reads_zero_where_the_flags_agree_and_the_scores_distance_otherwise():
    want = torch.tensor([0.9, 0.49, 0.5001, -3.0])
    own = compare.served("flag_gap", want, threshold=0.5)
    assert own.tolist() == [True, False, True, False]
    assert compare.flag_gap(own, want, threshold=0.5) == 0.0
    assert compare.flag_gap(own ^ torch.tensor([False, False, True, False]), want, threshold=0.5) == pytest.approx(
        1e-4, rel=1e-3)
    assert compare.flag_gap(own ^ torch.tensor([True, True, False, True]), want, threshold=0.5) == pytest.approx(3.5)


def test_a_single_limit_is_the_depth_field_under_its_bare_name():
    assert compare.fields({"compare": "u8_gap", "limit": 3e-4}) == {
        "depth": {"compare": "u8_gap", "limit": 3e-4, "args": {}, "key": "u8_gap"}}
    with pytest.raises(ValueError):
        compare.fields({"fields": {"x": {"compare": "no_such", "limit": 1}}})


def _digest(state):
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, seed, digest", [
    ("dpt_large", 2 ** 31 + 5, "b882a5163647b391ae99f9ca7d836c2ec18eb5b2d1c4092b1e6a73fd329ca5dc"),
    ("dpt_large", 7, "6347e2b11b5bf5e80396c6edf13de361b0da68b7f357780f07073e449ef2dc99"),
    ("dpt_hybrid", 2 ** 31 + 5, "4f5d0d4d9aa6e26c023f43f77c9b41402fd13ed263bae23f7e6eb2c9c38833b5"),
    ("dpt_hybrid", 7, "04f82d2bcc350dd7dd49b326abd1596e5b3790f9ba3b9e9c4c021e8ea7240769")])
def test_the_dpt_weights_are_the_same_bits_as_before_buffers_and_heads(name, seed, digest):
    """Digests of the state dicts that make_weights gave before it filled
    buffers and read ``weights.heads`` (the tiny configurations, the CPU)."""
    torch.set_num_threads(2)
    assert _digest(make_weights(tiny_config(name), seed, "cpu")) == digest


def test_a_batchnorm_family_loads_strictly_with_its_buffers_and_heads(spec):
    cfg = twonet_config()
    state = make_weights(cfg, SEED, "cpu")
    model = ref.build_model(cfg, state, "cpu")  # load_state_dict is strict
    assert set(state) == set(model.state_dict())
    bn = model.det.bn
    assert torch.equal(bn.running_mean, torch.zeros(8)) and torch.equal(bn.running_var, torch.ones(8))
    assert bn.num_batches_tracked.dtype == torch.long and int(bn.num_batches_tracked) == 0
    assert torch.equal(bn.weight, torch.ones(8)) and torch.equal(bn.bias, torch.zeros(8))
    plain = copy.deepcopy(cfg)
    plain["weights"]["heads"] = [plain["weights"]["heads"][0]]
    other = make_weights(plain, SEED, "cpu")
    assert torch.equal(state["det.score.bias"], other["det.score.bias"] + 0.1)
    assert torch.equal(state["det.score.weight"], other["det.score.weight"])
    assert all(torch.equal(state[k], other[k]) for k in state if not k.startswith("det.score."))


def test_an_unknown_persistent_buffer_has_no_rule():
    class Counted(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("table", torch.zeros(3))

    fam = types.ModuleType("portbench.reference.counted")
    fam.build = lambda cfg: Counted()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, fam.__name__, fam)
        with pytest.raises(ValueError, match="table"):
            make_weights({"reference": "counted", "weights": {"heads": []}}, 1, "cpu")


def test_the_operations_of_several_nets_are_each_nets_at_its_input(spec):
    cfg = twonet_config()
    depth = roofline.network_flops(tiny_config("dpt_large"))
    det = 2 * 8 * 8 * 8 * 3 * 9 + 2 * 8 * 8 * (1 + 2) * 8  # the 3x3 conv at 8x8, the two 1x1 heads
    assert roofline.network_flops(cfg) == depth + det
