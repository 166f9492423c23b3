"""BlazePose person detector and landmark network (JAX ``models/blazepose.py``), NCHW.

* ``BlazePoseDetector``: MediaPipe's pose_detection SSD on a 224×224 input
  in [-1, 1], MPBlocks down to 7×7 and heads on the 28×28 and 14×14 maps (2
  anchors a cell) and the 7×7 map (6 a cell): 2254 anchors × (1 score + 12
  box and keypoint regressions). Decode and NMS are ``detect/anchors.py``.
* ``BlazePose``: a 256×256 person crop → 33 landmarks × (x, y in crop
  pixels, z, visibility, presence; the last two raw logits) and a
  pose-presence probability. The heatmap branch (decoded back to 64×64×39
  with skips) feeds only ``return_full=True``; the JAX inference program
  drops it as dead code, so the port builds it and runs it only when asked.
  With ``return_full=True`` the layers run in the JAX module's order
  (encoder, heatmap, regression, ``ld_3d``, ``world_3d``, ``pose_flag``),
  which the ``.tflite`` converter matches the file's operator stream against
  (``utils/convert.py::tflite_layer_order``).

Module names are the Flax module names (``utils/convert.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from depth_estimation_tpu_torch.models.blazeface import ssd_head
from depth_estimation_tpu_torch.models.layers import Conv2dSame, MPBlock, PReLU

NUM_LANDMARKS = 33
NUM_RAW_LANDMARKS = 39  # 33 + 6 auxiliary alignment landmarks
INPUT_SIZE = 256
DETECTOR_INPUT_SIZE = 224
# (name, in, out, stride) down to the 7×7 map; f28, f14 and f7 are the outputs of b28_2, b14_2 and b7_2
DETECTOR_ENCODER = (("b112_0", 24, 24, 1), ("b112_1", 24, 24, 1), ("down56", 24, 48, 2),
                    *((f"b56_{i}", 48, 48, 1) for i in range(3)), ("down28", 48, 96, 2),
                    *((f"b28_{i}", 96, 96, 1) for i in range(3)), ("down14", 96, 96, 2),
                    *((f"b14_{i}", 96, 96, 1) for i in range(3)), ("down7", 96, 96, 2),
                    *((f"b7_{i}", 96, 96, 1) for i in range(3)))
# (feature map, anchors a cell): 28²·2 + 14²·2 + 7²·6 = 2254 anchors
DETECTOR_HEADS = (("28", 2), ("14", 2), ("7", 6))
# (name, in, out, stride) down to the 8×8 map; f64, f32, f16 and f8 are the
# outputs of the last block of each scale
ENCODER = (("b128_0", 16, 16, 1), ("down64", 16, 32, 2), ("b64_0", 32, 32, 1), ("b64_1", 32, 32, 1),
           ("down32", 32, 64, 2), ("b32_0", 64, 64, 1), ("b32_1", 64, 64, 1),
           ("down16", 64, 128, 2), ("b16_0", 128, 128, 1), ("b16_1", 128, 128, 1),
           ("down8", 128, 192, 2), ("b8_0", 192, 192, 1), ("b8_1", 192, 192, 1))
SKIPS = ("b64_1", "b32_1", "b16_1")


class BlazePoseDetector(nn.Module):
    """(B, 3, 224, 224) in [-1, 1] → (raw_boxes (B, 2254, 12), raw_scores (B, 2254))."""

    def __init__(self):
        super().__init__()
        self.stem = Conv2dSame(3, 24, 5, 2, bias=True)
        self.stem_act = PReLU(24)
        for name, cin, cout, s in DETECTOR_ENCODER:
            self.add_module(name, MPBlock(cin, cout, s))
        for tag, per_cell in DETECTOR_HEADS:
            self.add_module(f"classifier_{tag}", nn.Conv2d(96, per_cell, 1))
            self.add_module(f"regressor_{tag}", nn.Conv2d(96, per_cell * 12, 1))

    def forward(self, x: torch.Tensor):
        h = self.stem_act(self.stem(x))
        maps = {}
        for name, *_ in DETECTOR_ENCODER:
            h = getattr(self, name)(h)
            maps[name] = h
        scores, boxes = [], []
        for tag, _per_cell in DETECTOR_HEADS:  # classifier, then regressor, a map at a time, as JAX runs them
            fm = maps[f"b{tag}_2"]
            scores.append(ssd_head(getattr(self, f"classifier_{tag}"), fm, 1))
            boxes.append(ssd_head(getattr(self, f"regressor_{tag}"), fm, 12))
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)


def _up2(t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class BlazePose(nn.Module):
    """(B, 3, 256, 256) in [0, 1] → (landmarks (B, 33, 5), score (B,));
    ``return_full=True`` adds {"ld_raw" (B, 39, 5), "heatmap" (B, 64, 64, 39),
    "world" (B, 39, 3)}."""

    def __init__(self):
        super().__init__()
        self.stem = Conv2dSame(3, 16, 3, 2, bias=True)
        self.stem_act = PReLU(16)
        for name, cin, cout, s in ENCODER:
            self.add_module(name, MPBlock(cin, cout, s))
        self.hm_lat8 = nn.Conv2d(192, 128, 1)
        self.hm_lat16 = nn.Conv2d(128, 128, 1)
        self.hm_b16 = MPBlock(128, 128)
        self.hm_proj32 = nn.Conv2d(128, 64, 1)
        self.hm_lat32 = nn.Conv2d(64, 64, 1)
        self.hm_b32 = MPBlock(64, 64)
        self.hm_proj64 = nn.Conv2d(64, 32, 1)
        self.hm_lat64 = nn.Conv2d(32, 32, 1)
        self.hm_b64 = MPBlock(32, 32)
        self.hm_out = nn.Conv2d(32, NUM_RAW_LANDMARKS, 3, padding=1)
        self.reg_down4 = MPBlock(192, 256, 2)
        self.reg_b4 = MPBlock(256, 256)
        self.reg_down2 = MPBlock(256, 288, 2)
        self.reg_b2 = MPBlock(288, 288)
        self.reg_out = nn.Conv2d(288, 288, 2)
        self.reg_out_act = PReLU(288)
        self.ld_3d = nn.Linear(288, NUM_RAW_LANDMARKS * 5)
        self.world_3d = nn.Linear(288, NUM_RAW_LANDMARKS * 3)
        self.pose_flag = nn.Linear(288, 1)

    def _heatmap(self, f64, f32, f16, f8):
        d = _up2(self.hm_lat8(f8)) + self.hm_lat16(f16)
        d = self.hm_proj32(self.hm_b16(d))
        d = _up2(d) + self.hm_lat32(f32)
        d = self.hm_proj64(self.hm_b32(d))
        d = _up2(d) + self.hm_lat64(f64)
        return self.hm_out(self.hm_b64(d)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, return_full: bool = False):
        h = self.stem_act(self.stem(x))
        skips = []
        for name, *_ in ENCODER:
            h = getattr(self, name)(h)
            if name in SKIPS:
                skips.append(h)
        f8 = h
        heatmap = self._heatmap(*skips, f8) if return_full else None
        r = self.reg_b2(self.reg_down2(self.reg_b4(self.reg_down4(f8))))
        feat = self.reg_out_act(self.reg_out(r)).reshape(r.shape[0], -1)  # (B, 288)
        ld = self.ld_3d(feat).reshape(-1, NUM_RAW_LANDMARKS, 5)
        world = self.world_3d(feat).reshape(-1, NUM_RAW_LANDMARKS, 3) if return_full else None
        score = torch.reciprocal(1.0 + torch.exp(-self.pose_flag(feat)[:, 0]))
        if not return_full:
            return ld[:, :NUM_LANDMARKS], score
        return ld[:, :NUM_LANDMARKS], score, {"ld_raw": ld, "heatmap": heatmap, "world": world}
