"""A configuration of several nets, built for the tests as a later
configuration would arrive: a reference family, a program and a driver,
found by name. The program serves, a frame, a DPT depth map and the
outputs of a tiny SSD-like detector (one conv, one BatchNorm, a score head
and an offset head over an 8x8 grid of anchors):

* ``valid`` (bool, A): the anchor's score lies above the threshold;
* ``point`` (int32, A x 2): the anchor's point in frame pixels, (x, y),
  truncated toward zero;
* ``sample`` (f32, A): the depth map at each valid anchor's point, 0 at the
  others: a stage that follows the two discrete choices above.

The family's ``outputs`` is the reference's side: the depth map, the scores
(``flag_gap`` judges ``valid`` by them), the float points (``trunc_gap``)
and the samples taken at the program's own points and flags, so that a
point truncated to the other side of an integer does not fail ``sample``.
The program folds the BatchNorm into the conv, as a served program does.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import dpt
from portbench.reference import frame as ref

# -- the reference family ------------------------------------------------------


class Detector(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(3, channels, 3, stride=2, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(channels)
        self.score = nn.Conv2d(channels, 1, 1)
        self.offset = nn.Conv2d(channels, 2, 1)

    def forward(self, x):
        y = F.relu(self.bn(self.conv(x)))
        return self.score(y).flatten(1), self.offset(y).flatten(2).transpose(1, 2)  # (B, A), (B, A, 2)


class TwoNet(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.depth = dpt.build(cfg)
        self.det = Detector(cfg["detector"]["channels"])


def build(cfg: Dict) -> TwoNet:
    return TwoNet(cfg)


def upsampled_1x1(model: TwoNet):
    return dpt.upsampled_1x1(model.depth)


def count_inputs(cfg: Dict) -> Dict[str, tuple]:
    return {"depth": (1, 3, *cfg["net_hw"]), "det": (1, 3, *cfg["detector"]["net_hw"])}


def detector_input(frames_u8: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, H, W, 3) u8 BGR → (B, 3, h, w) RGB in [-1, 1] at the detector's size."""
    x = frames_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    return F.interpolate(x, size=tuple(cfg["detector"]["net_hw"]), mode="bilinear", align_corners=False) * 2 - 1


def anchor_points(offset: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, A, 2) offsets → (B, A, 2) points (x, y) in frame pixels: the
    anchor's centre plus the offset in cells."""
    H, W = cfg["input_hw"]
    gh, gw = (n // 2 for n in cfg["detector"]["net_hw"])
    ys, xs = torch.meshgrid(torch.arange(gh, device=offset.device), torch.arange(gw, device=offset.device),
                            indexing="ij")
    cell = torch.tensor([W / gw, H / gh], device=offset.device)
    centre = (torch.stack([xs, ys], -1).reshape(-1, 2) + 0.5) * cell
    return centre + offset * cell


def samples(depth: torch.Tensor, valid: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """The depth (B, H, W) at each valid int point (B, A, 2), clamped into the frame; 0 elsewhere."""
    H, W = depth.shape[1:]
    x, y = point[..., 0].long().clamp(0, W - 1), point[..., 1].long().clamp(0, H - 1)
    b = torch.arange(depth.shape[0], device=depth.device)[:, None]
    return torch.where(valid, depth[b, y, x], torch.zeros((), dtype=depth.dtype, device=depth.device))


def outputs(model: TwoNet, frames_u8: torch.Tensor, cfg: Dict, given: Optional[Dict[str, torch.Tensor]],
            tf32: bool = False) -> Dict[str, torch.Tensor]:
    depth = ref.depth_maps(model.depth, frames_u8, cfg, tf32=tf32)
    score, offset = model.det(detector_input(frames_u8, cfg))
    point = anchor_points(offset, cfg)
    if given is None:
        valid, ipoint = score > cfg["detector"]["threshold"], torch.trunc(point)
    else:
        valid, ipoint = given["valid"].bool(), given["point"]
    return {"depth": depth, "valid": score, "point": point, "sample": samples(depth, valid, ipoint)}


# -- the program under test and its driver --------------------------------------


class DetectorProgram:
    """The program's detector: the BatchNorm folded into the conv's weight
    and bias, the score thresholded and the points truncated as served."""

    def __init__(self, state: Dict[str, torch.Tensor], cfg: Dict):
        self.cfg = cfg
        bn = {k: state[f"det.bn.{k}"] for k in ("weight", "bias", "running_mean", "running_var")}
        scale = bn["weight"] * torch.rsqrt(bn["running_var"] + 1e-5)
        self.conv_w = state["det.conv.weight"] * scale[:, None, None, None]
        self.conv_b = bn["bias"] - bn["running_mean"] * scale
        self.heads = {k: (state[f"det.{k}.weight"], state[f"det.{k}.bias"]) for k in ("score", "offset")}

    def flags(self, score: torch.Tensor) -> torch.Tensor:
        return score > self.cfg["detector"]["threshold"]

    def points(self, offset: torch.Tensor) -> torch.Tensor:
        return torch.trunc(anchor_points(offset, self.cfg)).to(torch.int32)

    def __call__(self, frames_u8: torch.Tensor, depth: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            y = F.relu(F.conv2d(detector_input(frames_u8, self.cfg), self.conv_w, self.conv_b, stride=2, padding=1))
            score = F.conv2d(y, *self.heads["score"]).flatten(1)
            offset = F.conv2d(y, *self.heads["offset"]).flatten(2).transpose(1, 2)
            valid = self.flags(score)
            point = self.points(offset)
            return {"valid": valid, "point": point, "sample": samples(depth, valid, point)}


def run(ctx):
    """Traffic keys: ``frames``, the frames served one at a time in a closed loop."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator

    from portbench.harness import Outcome
    from portbench.weights import make_weights

    weights = make_weights(ctx.config, ctx.seed, ctx.device)
    est = DepthEstimator(ctx.config["model_type"], params={k[len("depth."):]: v for k, v in weights.items()
                                                          if k.startswith("depth.")},
                         device=ctx.device, verbose=False)
    det = DetectorProgram(weights, ctx.config)
    del weights
    ctx.mark("programs")
    depth_fn = est._batched_fn(tuple(ctx.config["input_hw"]), "f32")

    def program(frames):
        depth = depth_fn(frames)
        return {"depth": depth, **det(torch.from_numpy(frames), depth)}

    program(ctx.frames.stack([0]))
    n = int(ctx.traffic["frames"])
    ctx.begin_window()
    outputs, done = {}, []
    for i in range(n):
        out = program(ctx.frames.stack([i]))
        outputs[i] = {k: v[0].numpy() for k, v in out.items()}
        done.append(time.perf_counter())
    ctx.end_window()

    def release():
        est.model = None

    return Outcome(attempted=n, failed=0, due=None, done=done, outputs=outputs, output="f32", rows_per_program=1,
                   release=release)
