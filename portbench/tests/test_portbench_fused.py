"""The ``fused_iris`` configuration on the CPU: its reference family
(``reference/fused_iris.py``) against the program (``FusedVidStream`` and the
fused frame program, through ``drivers/fused.py``), at 48x64 frames with the
tiny DPT of ``tiny_spec`` and the detectors at their published widths.

The driver sets BlazeFace's score bias from the seed's first frames
(``score_biased``); the test configuration asks it to put the middle of the
first 8 frames' best scores 1e-4 above the 0.2 threshold, so that some frames
hit, some miss and one lies near the threshold. Sound, the cell is correct; a
mesh point one past its truncation, an altered pose or iris sample, or a hit
flipped far from the threshold is not; a hit flipped within rounding of it
is."""

import copy
import json

import pytest
import torch

from portbench import harness, roofline
from portbench.frames import Frames
from portbench.reference import frame as ref
from portbench.reference import fused_iris as fi
from portbench.spec import HERE, Spec
from portbench.weights import make_weights

CELL = "fused_iris.video_mb4"
SEED = 2 ** 31 + 9
SECONDS = 0.6  # at least the first 8 frames on this CPU
SERVED = 8  # the frames the bias is set from: the first frames served
NEAR = 1e-4  # the near frame's best score above the threshold: ten times a score's rounding here
FLAG_LIMIT = json.loads((HERE / "limits" / f"{CELL}.json").read_text())["fields"]["valid"]["limit"]


def _scores(cfg, seed: int, n: int):
    """BlazeFace's best score on each of the seed's first ``n`` frames, on
    the weights of ``cfg``."""
    model = ref.build_model(cfg, make_weights(cfg, seed, "cpu"), "cpu")
    frames = torch.from_numpy(Frames(seed, cfg["input_hw"], "cpu").stack(range(n)))
    return torch.sigmoid(fi.best_logits(model.blazeface, frames).double()).tolist()


@pytest.fixture(scope="module")
def fused(tiny_spec, tmp_path_factory):
    """The tiny benchmark with the fused configuration's score rule set on
    the first SERVED frames, the best score at rank SERVED // 2 at the
    threshold plus NEAR. Yields the spec and those frames' best scores on the
    weights the driver draws."""
    cfg = json.loads((tiny_spec.root / "fused_iris.json").read_text())
    threshold = cfg["detectors"]["blazeface"]["min_detection_con"]
    cfg["detectors"]["blazeface"]["score_bias"].update(pool_frames=SERVED, rank=SERVED // 2, score=threshold + NEAR)
    root = tmp_path_factory.mktemp("fused_bench")
    (root / "fused_iris.json").write_text(json.dumps(cfg))
    bench = copy.deepcopy(tiny_spec.bench)
    for c in bench["configs"]:
        c["file"] = str(root / "fused_iris.json") if c["name"] == "fused_iris" else str(tiny_spec.root / c["file"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shifted = fi.score_biased(cfg, SEED, Frames(SEED, cfg["input_hw"], "cpu"), "cpu")
    yield Spec(root), _scores(shifted, SEED, SERVED)


@pytest.mark.parametrize("seed", [SEED, 7, 2 ** 33 + 5])
def test_the_score_rule_puts_half_of_the_seeds_first_frames_above_the_threshold(tiny_spec, seed):
    cfg = tiny_spec.config("fused_iris")
    rule = cfg["detectors"]["blazeface"]["score_bias"]
    assert (rule["pool_frames"], rule["rank"], rule["score"]) == (16, 7.5, 0.2)
    shifted = fi.score_biased(cfg, seed, Frames(seed, cfg["input_hw"], "cpu"), "cpu")
    added = shifted["weights"]["heads"][len(cfg["weights"]["heads"]):]
    assert [h["param"] for h in added] == rule["heads"] and len({h["bias"] for h in added}) == 1
    assert shifted["weights"]["heads"][:len(cfg["weights"]["heads"])] == cfg["weights"]["heads"]
    scores = sorted(_scores(shifted, seed, 16))
    assert scores[7] < 0.2 < scores[8]
    mid = (torch.logit(torch.tensor(scores[7:9], dtype=torch.float64))).tolist()
    assert sum(mid) / 2 == pytest.approx(torch.logit(torch.tensor(0.2, dtype=torch.float64)).item(), abs=1e-4)


def _run(spec):
    return harness.run_cell(spec, CELL, SEED, SECONDS, False, device="cpu")


def test_the_reference_and_the_program_load_one_state_dict_strictly(fused):
    from depth_estimation_tpu_torch.models.blazeface import BlazeFace
    from depth_estimation_tpu_torch.models.blazepose import BlazePose
    from depth_estimation_tpu_torch.models.facemesh import FaceMeshWithIris

    spec, _ = fused
    cfg = spec.config("fused_iris")
    state = make_weights(cfg, SEED, "cpu")
    model = ref.build_model(cfg, state, "cpu")  # load_state_dict is strict
    assert set(state) == set(model.state_dict())
    for name, net in (("blazeface", BlazeFace()), ("facemesh", FaceMeshWithIris()), ("blazepose", BlazePose())):
        part = {k[len(name) + 1:]: v for k, v in state.items() if k.startswith(name + ".")}
        net.load_state_dict(part, strict=True)
        assert part and all(torch.equal(v, net.state_dict()[k]) for k, v in part.items())
    assert {k.split(".")[0] for k in state} == {"depth", "blazeface", "facemesh", "blazepose"}


def test_a_sound_run_with_hits_and_misses_is_correct(fused):
    spec, scores = fused
    threshold = spec.config("fused_iris")["detectors"]["blazeface"]["min_detection_con"]
    assert sum(s >= threshold for s in scores) >= 3 and sum(s < threshold for s in scores) >= 3
    r = _run(spec)
    assert r["correct"], r["checks"]
    assert r["checks"]["compared"]["value"] >= SERVED
    fields = json.loads((HERE / "limits" / f"{CELL}.json").read_text())["fields"]
    assert list(r["checks"])[2:] == [f"{f}.{c['compare']}" for f, c in fields.items()]
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}


def _patch_outputs(monkeypatch, change):
    """Alter the fused program's outputs as they leave it."""
    from depth_estimation_tpu_torch.runtime import fused as program

    make = program.make_fused_iris_frame_fn

    def broken(*args, **kwargs):
        fn = make(*args, **kwargs)

        def run(frames, pts):
            return change(fn(frames, pts))
        return run
    monkeypatch.setattr(program, "make_fused_iris_frame_fn", broken)


def _mesh_one_past(out):
    hit = out["valid"][:, 0]
    out["mesh"] = out["mesh"].clone()
    out["mesh"][:, :468] += hit.to(torch.int32)[:, None, None]  # each point but the irises', one past
    return out


def _pose_altered(out):
    miss = ~out["valid"][:, 0]
    out["pose_lm"] = out["pose_lm"].clone()
    out["pose_lm"][:, 0, 0] += miss.float()
    return out


def _iris_sample_altered(out):
    out["iris_sample"] = out["iris_sample"] + 10.0
    return out


@pytest.mark.parametrize("change, key", [(_mesh_one_past, "mesh.trunc_gap"), (_pose_altered, "pose_lm.max_scaled_err"),
                                         (_iris_sample_altered, "iris_sample.max_scaled_err")])
def test_an_altered_field_is_not_correct(fused, monkeypatch, change, key):
    spec, _ = fused
    _patch_outputs(monkeypatch, change)
    r = _run(spec)
    assert not r["correct"], r["checks"]
    failed = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert failed == {key}, r["checks"]
    if key == "mesh.trunc_gap":
        assert r["checks"][key]["value"] > 0.9


def _threshold_raised(monkeypatch, by: float):
    """The program's detection threshold raised by ``by`` (the reference's
    stays): the hits scoring less than that above it flip to misses."""
    from depth_estimation_tpu_torch.runtime import fused as program

    branch = program.blazeface_branch

    def raised(net, anchors, thresh, frames):
        return branch(net, anchors, thresh + by, frames)
    monkeypatch.setattr(program, "blazeface_branch", raised)


def test_a_hit_flipped_far_from_the_threshold_is_not_correct(fused, monkeypatch):
    spec, scores = fused
    threshold = spec.config("fused_iris")["detectors"]["blazeface"]["min_detection_con"]
    above = sorted(s - threshold for s in scores if s - threshold > 10 * NEAR)
    assert above[0] > 10 * FLAG_LIMIT and (len(above) == 1 or above[1] > above[0] + 2 * FLAG_LIMIT)
    _threshold_raised(monkeypatch, above[0] + FLAG_LIMIT)  # the near frame and the next one up flip
    r = _run(spec)
    assert not r["correct"], r["checks"]
    assert r["checks"]["valid.flag_gap"]["value"] == pytest.approx(above[0], abs=FLAG_LIMIT)


def test_a_hit_flipped_within_rounding_of_the_threshold_is_correct(fused, monkeypatch):
    spec, _ = fused
    _threshold_raised(monkeypatch, 2 * NEAR)  # the near frame flips to a miss
    r = _run(spec)
    assert r["correct"], r["checks"]
    assert 2 * NEAR < FLAG_LIMIT
    assert 0.5 * NEAR < r["checks"]["valid.flag_gap"]["value"] < 2 * NEAR


def test_the_operations_are_dpt_larges_and_each_detectors_at_its_input():
    from torch.utils.flop_counter import FlopCounterMode

    from depth_estimation_tpu_torch.models.blazeface import BlazeFace
    from depth_estimation_tpu_torch.models.blazepose import BlazePose
    from depth_estimation_tpu_torch.models.facemesh import FaceMeshWithIris

    cfg = Spec().config("fused_iris")
    dpt_large = roofline.network_flops(Spec().config("dpt_large"))
    assert round(dpt_large / 1e9) == 696
    detectors = 0.0
    with torch.device("meta"):
        for net, size in ((BlazeFace(), 128), (FaceMeshWithIris(), 192), (BlazePose(), 256)):
            with FlopCounterMode(display=False) as counter, torch.no_grad():
                net(torch.empty(1, 3, size, size))
            detectors += counter.get_total_flops()
    assert 0.2e9 < detectors < 5e9
    assert roofline.network_flops(cfg) == pytest.approx(dpt_large + detectors, rel=1e-12)


class _Record:
    window = (10.0, 20.0)

    def __init__(self, spans):
        self.out = type("Out", (), {"spans": spans})()


def _read(name, spans):
    from portbench import spec

    return spec.reader(name).read(_Record(spans), {"name": name})


def test_the_fused_loops_readers_read_the_spans_as_tuples():
    program = [(10.5 + k, 10.7 + k, "program") for k in range(12)]  # the last two start after the window
    children = [(10.501 + k + 0.05 * i, 10.501 + k + 0.05 * i + 0.001 * (k + 1) * (i + 1), name)
                for k in range(12) for i, name in enumerate(("program.face", "program.mesh", "program.pose"))]
    depth = [(10.502 + k, 10.54 + k, "program.network") for k in range(12)]
    # program k: 6 (k + 1) ms of detectors; the ten in the window: 6 to 60 ms
    assert _read("detector_launch_ms_p50.fps", program + children + depth) == pytest.approx(33.0)
    frames = [(10.05 + 0.09 * i, 10.05 + 0.09 * i + 0.001 * (i % 20 + 1), "stream.host_frame") for i in range(100)]
    routes = [(s + 1e-4, e - 1e-4, "stream.iris_path" if i % 4 == 0 else "stream.body_path")
              for i, (s, e, _) in enumerate(frames)]
    late = [(20.5, 20.6, "stream.host_frame"), (20.51, 20.59, "stream.iris_path")]
    assert _read("host_frame_ms_p95.fps", frames + routes + late) == pytest.approx(19.05)
    assert _read("iris_route_share.fps", frames + routes + late) == pytest.approx(25.0)
    for name in ("detector_launch_ms_p50.fps", "host_frame_ms_p95.fps", "iris_route_share.fps"):
        assert _read(name, [(11.0, 12.0, "sink write")]) is None  # the parent's loop records no spans
