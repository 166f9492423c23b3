"""A run on the CPU, with the card check skipped, at a tiny size: sound, it
comes out correct; with the served path broken underneath, it comes out
not correct. The faults a cell of this benchmark can have: an answer
altered where it is produced, and half of a batch left out (its rows
served from the other half). A training step's state and an exchange
between chips do not occur in these cells."""

import pytest
import torch

from portbench import harness

SECONDS = 0.6


def _run(spec, cell, seed=2 ** 31 + 9):
    return harness.run_cell(spec, cell, seed, SECONDS, False, device="cpu")


def _altered(run):
    def broken(self, imgs, output="f32", model=None):
        out = run(self, imgs, output, model).clone()
        out[0, 3, 5] += 1 if out.dtype == torch.uint8 else 1.0  # one value of one answer
        return out
    return broken


def _half_left_out(run):
    def broken(self, imgs, output="f32", model=None):
        half = max(1, imgs.shape[0] // 2)
        out = run(self, imgs[:half], output, model)
        return torch.cat([out] * 2)[:imgs.shape[0]] if imgs.shape[0] > 1 else out
    return broken


@pytest.mark.parametrize("cell", ["dpt_large.serve_poisson", "dpt_large.video_mb4", "dpt_large.webcam30"])
def test_a_sound_run_is_correct(tiny_spec, cell):
    r = _run(tiny_spec, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell, fault", [
    ("dpt_large.serve_poisson", _altered), ("dpt_large.serve_poisson", _half_left_out),
    ("dpt_large.video_mb4", _altered), ("dpt_large.video_mb4", _half_left_out),
    ("dpt_large.webcam30", _altered)])
def test_a_broken_program_is_not_correct(tiny_spec, monkeypatch, cell, fault):
    from depth_estimation_tpu_torch.estimator import DepthEstimator

    monkeypatch.setattr(DepthEstimator, "_run", fault(DepthEstimator._run))
    r = _run(tiny_spec, cell)
    assert not r["correct"], r["checks"]
