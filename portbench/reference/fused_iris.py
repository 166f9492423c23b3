"""Plain PyTorch reference of the reference's fused pipeline
(``midas_mediapipe.py``): a DPT_Large depth map and MediaPipe 0.8.11's face and
body landmarks, each frame.

Written from the published models and graphs, not from the program under
test: DPT_Large (``dpt.py``, arXiv:2103.13413); BlazeFace short-range
(arXiv:1907.05047; ``face_detection_short_range``: 128x128 input in [-1, 1],
SSD anchors of strides 8, 16, 16, 16 with ``fixed_anchor_size``, 896 anchors
x 16 regressions, ``TensorsToDetectionsCalculator`` with scales 128,
``reverse_output_order`` and logits clipped at +-100 before the sigmoid,
``NonMaxSuppressionCalculator`` WEIGHTED at IoU 0.3); FaceMesh
(arXiv:1907.06724; ``face_landmark``: 192x192 in [0, 1], 468 x 3 points and a
presence logit) with the iris refinement (arXiv:2006.11341;
``iris_landmark``: 64x64 eye crops, 71 contour and 5 iris points, the right
eye mirrored; ``refine_landmarks`` assembles 478 points: 468-472 the right
iris, its centre first, 473-477 the left); BlazePose's landmark net
(arXiv:2006.10204; ``pose_landmark_full``: 256x256 in [0, 1], 39 x 5
regressions of which 33 are served, a presence logit). The widths are those
graphs'. The four nets keep the program's state-dict key names, so one state
dict loads strictly into both: submodules ``depth``, ``blazeface``,
``facemesh`` (``mesh`` and ``iris``) and ``blazepose``.

The frame around them is midas_mediapipe.py's: the detectors' input is the
whole /255 RGB frame resized bilinearly (half-pixel, no antialiasing); a hit
is the best detection's score at ``minDetectionCon`` (0.2); the face crop
is the best box with a 25% margin, each edge truncated to a pixel
(``_best_face_box``), resized bilinearly to 192x192 with sample points held
inside the crop; the eye crops are squares of 2.3 times the eye's corner
distance, clamped inside the face crop; the iris circles are the minimum
enclosing circles of each iris's four boundary points, on the int
landmarks; the output frame is ``to_video_frame``'s u8 of the depth map
(midas_mediapipe.py:141-150); the three depth samples are ``FaceDet.get_depth``'s
(face.py:91-116), quirks kept: truncating casts, ``img[x, y]`` indexing, x
clamped to the map's first axis, the left y slot holding the clamp of the
right y, an index numpy would wrap wrapped once.

Departures from MediaPipe's own pipeline that the program shares:

* both landmark branches run for every frame, and the one not taken is
  served as zeros: the mesh, its score and the circles on a miss, the pose
  on a hit; the samples are taken at those zeros all the same;
* BlazePose runs on the whole frame resized to 256x256, with no pose
  detector and no ROI (the reference's ``findBody``); its heatmap branch and
  world landmarks are held (their weights are in the state dict) and not
  run;
* the face ROI is the axis-aligned 25%-margin box above, not MediaPipe's
  rotated 1.5x rectangle, and the eye crops are axis-aligned squares;
* an index that numpy would refuse (below ``-n`` after one wrap) is wrapped
  once more and clamped into the axis, as the JAX program's gather does.

Where the program departs from MediaPipe and this reference does not: a best
box whose blend has no candidate (zero area, so no IoU above 0.3, not even
with itself) is kept here as decoded, as MediaPipe keeps it; the program's
blend divides a zero weight sum and serves zeros. The configuration's box
regressor heads give boxes about a third of the frame, as a face's are, so
no such box arises in its cell (an open question of the program).

The configuration's score heads are set from the seed (``score_biased``):
random weights on noise frames give a best logit that moves far more from
seed to seed than from frame to frame, so a fixed bias would make a seed hit
on every frame or on none. The rule moves the seed's pool frames' middle
best logit to the threshold, so that each seed's frames part hit, part miss.

``outputs`` holds the program's discrete choices fixed from ``given``: the
hit (``valid``), the crop box (truncated again from the served ``boxes``),
the int mesh (the circles and the iris sample follow from it), the stored
fallback points each frame was dispatched with (``fallback_pts``) and the
ear pixels (truncated from the served ``pose_lm``). Each choice is judged as
a field of its own, its value here the float it is made from: the best
score for ``valid``, the float landmarks for ``mesh``. ``vis_u8``'s value is
the depth map: the driver serves the output frame's byte decoded to the
depth's own wrap-around cast (``decode_vis``), which ``u8_gap`` judges. Each
depth sample is served beside the configuration's ``sample_scale`` (the
maps' range; ``on_scale``), so that its error is read on the map's scale.
"""

from __future__ import annotations

import copy
import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import dpt
from portbench.reference import frame as ref

FACE_HW, MESH_HW, IRIS_HW, POSE_HW = 128, 192, 64, 256
MESH_POINTS = 468
LEFT_IRIS = (474, 475, 476, 477)  # detectors.py's boundary points of each iris
RIGHT_IRIS = (469, 470, 471, 472)
RIGHT_EYE_CORNERS = (33, 133)  # the subject's right eye, image left
LEFT_EYE_CORNERS = (362, 263)
EYE_SCALE = 2.3
BODY_HEAD = (7, 8)  # the ears among BlazePose's 33 points
MARGIN = 0.25
IOU = 0.3
SCORE_CLIP = 100.0


def _pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's SAME padding of one axis: (before, after)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Conv2d):
    """A TFLite CONV_2D / DEPTHWISE_CONV_2D with SAME padding and a bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, k, stride, groups=groups, bias=True)

    def forward(self, x):
        (t, b), (l, r) = (_pads(n, self.kernel_size[0], self.stride[0]) for n in x.shape[-2:])
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, self.bias, self.stride, groups=self.groups)


class PReLU(nn.Module):
    """TFLite PRELU, one slope a channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        a = self.alpha.view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, a * x)


def _residual(x: torch.Tensor, channels: int, stride: int) -> torch.Tensor:
    """The graphs' residual branch: a 2x2 max pool at stride 2, then the
    channels zero-padded to the block's output."""
    if stride == 2:
        x = F.max_pool2d(x, 2, 2)
    return F.pad(x, (0, 0, 0, 0, 0, channels - x.shape[1]))


class DepthwiseBlock(nn.Module):
    """k x k depthwise (SAME, stride) and 1x1 pointwise, plus the residual,
    then ReLU (BlazeFace, ``act=None``) or PReLU (the landmark nets)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, k: int = 3, prelu: bool = True):
        super().__init__()
        self.stride, self.cout = stride, cout
        self.conv_dw = SameConv(cin, cin, k, stride, groups=cin)
        self.conv_pw = nn.Conv2d(cin, cout, 1)
        self.act = PReLU(cout) if prelu else None

    def forward(self, x):
        y = self.conv_pw(self.conv_dw(x)) + _residual(x, self.cout, self.stride)
        return F.relu(y) if self.act is None else self.act(y)


class IrisBlock(nn.Module):
    """The iris net's bottleneck: a k = stride VALID conv to half the
    channels and PReLU, a 3x3 depthwise, a 1x1 expansion, the residual,
    PReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        mid = cout // 2
        self.stride, self.cout = stride, cout
        self.conv_squeeze = nn.Conv2d(cin, mid, stride, stride)
        self.act_squeeze = PReLU(mid)
        self.conv_dw = nn.Conv2d(mid, mid, 3, padding=1, groups=mid)
        self.conv_expand = nn.Conv2d(mid, cout, 1)
        self.act = PReLU(cout)

    def forward(self, x):
        y = self.conv_expand(self.conv_dw(self.act_squeeze(self.conv_squeeze(x))))
        return self.act(y + _residual(x, self.cout, self.stride))


def _nhwc_rows(t: torch.Tensor, values: int) -> torch.Tensor:
    """A head's NCHW output as the TFLite graph reshapes its NHWC tensor:
    rows in (y, x, anchor of the cell) order, ``values`` a row."""
    t = t.permute(0, 2, 3, 1)
    return t.reshape(t.shape[0], -1, values)


class BlazeFace(nn.Module):
    """(B, 3, 128, 128) in [-1, 1] → raw regressions (B, 896, 16), raw logits (B, 896)."""

    def __init__(self):
        super().__init__()
        self.stem = SameConv(3, 24, 5, 2)
        widths16, down16 = (24, 28, 32, 36, 42, 48, 56, 64, 72, 80, 88), (2, 5)
        c = 24
        for i, w in enumerate(widths16):
            self.add_module(f"blaze_{i}", DepthwiseBlock(c, w, 2 if i in down16 else 1, 5, prelu=False))
            c = w
        for i in range(5):
            self.add_module(f"blaze2_{i}", DepthwiseBlock(c, 96, 2 if i == 0 else 1, 5, prelu=False))
            c = 96
        self.classifier_16 = nn.Conv2d(88, 2, 1)
        self.classifier_8 = nn.Conv2d(96, 6, 1)
        self.regressor_16 = nn.Conv2d(88, 32, 1)
        self.regressor_8 = nn.Conv2d(96, 96, 1)

    def forward(self, x):
        h = F.relu(self.stem(x))
        for i in range(11):
            h = getattr(self, f"blaze_{i}")(h)
        f16 = h
        for i in range(5):
            h = getattr(self, f"blaze2_{i}")(h)
        logits = torch.cat([_nhwc_rows(self.classifier_16(f16), 1), _nhwc_rows(self.classifier_8(h), 1)], 1)[..., 0]
        raw = torch.cat([_nhwc_rows(self.regressor_16(f16), 16), _nhwc_rows(self.regressor_8(h), 16)], 1)
        return raw, logits


def face_anchors(device) -> torch.Tensor:
    """SsdAnchorsCalculator of face_detection_short_range: strides 8, 16, 16,
    16 on a 128 input, aspect 1 plus the interpolated scale (2 anchors a
    layer a cell), layers of one stride sharing a grid, ``fixed_anchor_size``
    (unit width and height), offset 0.5 → (896, 2) centres (x, y)."""
    centres = []
    for grid, per_cell in ((16, 2), (8, 6)):
        for y in range(grid):
            for x in range(grid):
                centres += [((x + 0.5) / grid, (y + 0.5) / grid)] * per_cell
    return torch.tensor(centres, dtype=torch.float32, device=device)


def decode(raw: torch.Tensor, logits: torch.Tensor, anchors: torch.Tensor):
    """TensorsToDetections: boxes (B, N, 16) as (ymin, xmin, ymax, xmax,
    then 6 keypoints as (x, y)) in [0, 1] of the frame, scores (B, N)."""
    xc = raw[..., 0] / FACE_HW + anchors[:, 0]
    yc = raw[..., 1] / FACE_HW + anchors[:, 1]
    w, h = raw[..., 2] / FACE_HW, raw[..., 3] / FACE_HW
    kx = raw[..., 4::2] / FACE_HW + anchors[:, None, 0]
    ky = raw[..., 5::2] / FACE_HW + anchors[:, None, 1]
    corners = torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], -1)
    boxes = torch.cat([corners, torch.stack([kx, ky], -1).flatten(-2)], -1)
    return boxes, torch.sigmoid(logits.clamp(-SCORE_CLIP, SCORE_CLIP))


def _area(t: torch.Tensor) -> torch.Tensor:
    return (t[..., 2] - t[..., 0]).clamp(min=0) * (t[..., 3] - t[..., 1]).clamp(min=0)


def _iou(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of box (B, 4+) with each of boxes (B, N, 4+); 0 where the
    intersection is empty (a zero-area box intersects nothing)."""
    a, b = box[:, None, :4], boxes[..., :4]
    ih = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    iw = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = ih * iw
    return torch.where(inter > 0, inter / (_area(a) + _area(b) - inter).clamp_min(1e-30), torch.zeros_like(inter))


def best_detection(boxes: torch.Tensor, scores: torch.Tensor, hit: torch.Tensor, threshold: float) -> torch.Tensor:
    """The first detection of weighted NMS, (B, 16): the best-scoring
    candidate (the first of equal scores) blended, weighted by score, with
    every candidate at or above ``threshold`` whose IoU with it is above
    0.3, itself included; the best as decoded where nothing blends; zeros
    where ``hit`` is False. A hit whose best score lies below the threshold
    (a flip within rounding) blends it all the same."""
    top = scores.argmax(dim=1)
    b = torch.arange(len(top), device=boxes.device)
    best, best_score = boxes[b, top], scores[b, top]
    member = (_iou(best, boxes) > IOU) & (scores >= torch.clamp(best_score, max=threshold)[:, None])
    w = torch.where(member, scores, torch.zeros_like(scores))
    total = w.sum(dim=1, keepdim=True)
    blended = torch.where(total > 0, (w[..., None] * boxes).sum(1) / total.clamp_min(1e-30), best)
    return torch.where(hit[:, None], blended, torch.zeros_like(blended))


def crop_box(box: torch.Tensor, h: int, w: int):
    """``_best_face_box``: the box (B, 16) widened by 25% of its size a side,
    each edge clamped and truncated to a pixel → x0, x1, y0, y1 (B,) float32;
    at least one pixel each way."""
    ymin, xmin, ymax, xmax = box[:, 0], box[:, 1], box[:, 2], box[:, 3]
    bw, bh = xmax - xmin, ymax - ymin
    x0 = torch.trunc(((xmin - MARGIN * bw) * w).clamp(0.0, w - 2.0))
    x1 = torch.trunc(torch.maximum((xmax + MARGIN * bw) * w, x0 + 1.0).clamp(max=float(w)))
    y0 = torch.trunc(((ymin - MARGIN * bh) * h).clamp(0.0, h - 2.0))
    y1 = torch.trunc(torch.maximum((ymax + MARGIN * bh) * h, y0 + 1.0).clamp(max=float(h)))
    return x0, x1, y0, y1


def bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, lo_x, hi_x, lo_y, hi_y) -> torch.Tensor:
    """img (B, C, H, W) at the points xs (B, ow) x ys (B, oh) (pixel
    coordinates, pixel centres at integers), each clamped into [lo, hi] (B,
    or a number) first → (B, C, oh, ow)."""
    xs = torch.minimum(torch.maximum(xs, torch.as_tensor(lo_x, device=xs.device).reshape(-1, 1)),
                       torch.as_tensor(hi_x, device=xs.device).reshape(-1, 1))
    ys = torch.minimum(torch.maximum(ys, torch.as_tensor(lo_y, device=ys.device).reshape(-1, 1)),
                       torch.as_tensor(hi_y, device=ys.device).reshape(-1, 1))
    x0f, y0f = torch.floor(xs), torch.floor(ys)
    tx, ty = xs - x0f, ys - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.minimum(x0 + 1, torch.as_tensor(hi_x, device=xs.device).reshape(-1, 1).ceil().long())
    y1 = torch.minimum(y0 + 1, torch.as_tensor(hi_y, device=ys.device).reshape(-1, 1).ceil().long())
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    hwc = img.permute(0, 2, 3, 1)

    def at(y, x):
        return hwc[b, y[:, :, None], x[:, None, :]]  # (B, oh, ow, C)

    tx, ty = tx[:, None, :, None], ty[:, :, None, None]
    out = (at(y0, x0) * (1 - tx) + at(y0, x1) * tx) * (1 - ty) + (at(y1, x0) * (1 - tx) + at(y1, x1) * tx) * ty
    return out.permute(0, 3, 1, 2)


def _centres(n: int, size, device) -> torch.Tensor:
    """Sample points of an n-pixel resize of ``size`` (B,) source pixels:
    half-pixel mapping → (B, n), relative to the source's first pixel."""
    grid = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    return grid * (size[:, None] / n) - 0.5


class FaceMesh(nn.Module):
    """(B, 3, 192, 192) in [0, 1] → points (B, 468, 3) in crop pixels, presence logit (B,)."""

    PLAN = ((16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1),
            (128, 2), (128, 1), (128, 1), (128, 2), (128, 1), (128, 1))

    def __init__(self):
        super().__init__()
        self.stem = SameConv(3, 16, 3, 2)
        self.stem_act = PReLU(16)
        c = 16
        for i, (w, s) in enumerate(self.PLAN):
            self.add_module(f"block_{i}", DepthwiseBlock(c, w, s))
            c = w
        for tag, out in (("coord", MESH_POINTS * 3), ("conf", 1)):
            self.add_module(f"{tag}_block_a", DepthwiseBlock(128, 128, 2))
            self.add_module(f"{tag}_conv", nn.Conv2d(128, 32, 1))
            self.add_module(f"{tag}_act", PReLU(32))
            self.add_module(f"{tag}_block_b", DepthwiseBlock(32, 32))
            self.add_module(f"{tag}_out", nn.Conv2d(32, out, 3))

    def _head(self, tag: str, h):
        for part in ("block_a", "conv", "act", "block_b", "out"):
            h = getattr(self, f"{tag}_{part}")(h)
        return h.flatten(1)

    def forward(self, x):
        h = self.stem_act(self.stem(x))
        for i in range(len(self.PLAN)):
            h = getattr(self, f"block_{i}")(h)
        return self._head("coord", h).reshape(-1, MESH_POINTS, 3), self._head("conf", h)[:, 0]


class IrisLandmark(nn.Module):
    """(B, 3, 64, 64) in [0, 1] → eye contour (B, 71, 3), iris (B, 5, 3) in crop pixels."""

    def __init__(self):
        super().__init__()
        self.stem = SameConv(3, 64, 3, 2)
        self.stem_act = PReLU(64)
        self.trunk = ([(f"back_a_{i}", 64, 64, 1) for i in range(4)] + [("back_down1", 64, 128, 2)]
                      + [(f"back_b_{i}", 128, 128, 1) for i in range(4)] + [("back_down2", 128, 128, 2)]
                      + [(f"back_c_{i}", 128, 128, 1) for i in range(4)])
        for name, cin, cout, s in self.trunk:
            self.add_module(name, IrisBlock(cin, cout, s))
        for tag, out in (("eye", 71 * 3), ("iris", 5 * 3)):
            for part, s in (("down1", 2), ("a", 1), ("b", 1), ("down2", 2), ("c", 1), ("d", 1)):
                self.add_module(f"{tag}_{part}", IrisBlock(128, 128, s))
            self.add_module(f"{tag}_out", nn.Conv2d(128, out, 2))

    def _branch(self, tag: str, h):
        for part in ("down1", "a", "b", "down2", "c", "d", "out"):
            h = getattr(self, f"{tag}_{part}")(h)
        return h.flatten(1)

    def forward(self, x):
        h = self.stem_act(self.stem(x))
        for name, *_ in self.trunk:
            h = getattr(self, name)(h)
        return self._branch("eye", h).reshape(-1, 71, 3), self._branch("iris", h).reshape(-1, 5, 3)


class FaceMeshWithIris(nn.Module):
    """``refine_landmarks``: (B, 3, 192, 192) in [0, 1] → 478 points (B, 478,
    3) in crop pixels and the face's presence score (B,)."""

    def __init__(self):
        super().__init__()
        self.mesh = FaceMesh()
        self.iris = IrisLandmark()

    def _eye(self, x, pts, corners, mirror: bool):
        """One eye's five iris points in crop pixels: a square crop of 2.3
        times the corners' distance around their midpoint (at least 8
        pixels, clamped inside the crop), resized to 64x64, mirrored for the
        right eye and back."""
        p0, p1 = pts[:, corners[0], :2], pts[:, corners[1], :2]
        centre = (p0 + p1) / 2
        side = (torch.sqrt(((p1 - p0) ** 2).sum(-1)) * EYE_SCALE).clamp(8.0, float(MESH_HW))
        x0 = torch.minimum((centre[:, 0] - side / 2).clamp(min=0.0), MESH_HW - side)
        y0 = torch.minimum((centre[:, 1] - side / 2).clamp(min=0.0), MESH_HW - side)
        grid = _centres(IRIS_HW, side, x.device)
        crop = bilinear(x, x0[:, None] + grid, y0[:, None] + grid, 0.0, MESH_HW - 1.0, 0.0, MESH_HW - 1.0)
        if mirror:
            crop = crop.flip(-1)
        _contour, iris = self.iris(crop)
        ix = IRIS_HW - iris[..., 0] if mirror else iris[..., 0]
        s = (side / IRIS_HW)[:, None]
        return torch.stack([x0[:, None] + ix * s, y0[:, None] + iris[..., 1] * s, iris[..., 2] * s], -1)

    def forward(self, x):
        pts, logit = self.mesh(x)
        right = self._eye(x, pts, RIGHT_EYE_CORNERS, mirror=True)
        left = self._eye(x, pts, LEFT_EYE_CORNERS, mirror=False)
        return torch.cat([pts, right, left], 1), torch.sigmoid(logit)


class BlazePose(nn.Module):
    """(B, 3, 256, 256) in [0, 1] → 33 points x (x, y in crop pixels, z,
    visibility, presence) (B, 33, 5) and the pose's presence score (B,). The
    heatmap branch (``hm_*``) and ``world_3d`` hold weights and do not run."""

    ENCODER = (("b128_0", 16, 16, 1), ("down64", 16, 32, 2), ("b64_0", 32, 32, 1), ("b64_1", 32, 32, 1),
               ("down32", 32, 64, 2), ("b32_0", 64, 64, 1), ("b32_1", 64, 64, 1),
               ("down16", 64, 128, 2), ("b16_0", 128, 128, 1), ("b16_1", 128, 128, 1),
               ("down8", 128, 192, 2), ("b8_0", 192, 192, 1), ("b8_1", 192, 192, 1))

    def __init__(self):
        super().__init__()
        self.stem = SameConv(3, 16, 3, 2)
        self.stem_act = PReLU(16)
        for name, cin, cout, s in self.ENCODER:
            self.add_module(name, DepthwiseBlock(cin, cout, s))
        self.hm_lat8 = nn.Conv2d(192, 128, 1)
        self.hm_lat16 = nn.Conv2d(128, 128, 1)
        self.hm_b16 = DepthwiseBlock(128, 128)
        self.hm_proj32 = nn.Conv2d(128, 64, 1)
        self.hm_lat32 = nn.Conv2d(64, 64, 1)
        self.hm_b32 = DepthwiseBlock(64, 64)
        self.hm_proj64 = nn.Conv2d(64, 32, 1)
        self.hm_lat64 = nn.Conv2d(32, 32, 1)
        self.hm_b64 = DepthwiseBlock(32, 32)
        self.hm_out = nn.Conv2d(32, 39, 3, padding=1)
        self.reg_down4 = DepthwiseBlock(192, 256, 2)
        self.reg_b4 = DepthwiseBlock(256, 256)
        self.reg_down2 = DepthwiseBlock(256, 288, 2)
        self.reg_b2 = DepthwiseBlock(288, 288)
        self.reg_out = nn.Conv2d(288, 288, 2)
        self.reg_out_act = PReLU(288)
        self.ld_3d = nn.Linear(288, 39 * 5)
        self.world_3d = nn.Linear(288, 39 * 3)
        self.pose_flag = nn.Linear(288, 1)

    def forward(self, x):
        h = self.stem_act(self.stem(x))
        for name, *_ in self.ENCODER:
            h = getattr(self, name)(h)
        for name in ("reg_down4", "reg_b4", "reg_down2", "reg_b2", "reg_out", "reg_out_act"):
            h = getattr(self, name)(h)
        feat = h.flatten(1)
        return self.ld_3d(feat).reshape(-1, 39, 5)[:, :33], torch.sigmoid(self.pose_flag(feat)[:, 0])


class FusedIris(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.depth = dpt.build(cfg)
        self.blazeface = BlazeFace()
        self.facemesh = FaceMeshWithIris()
        self.blazepose = BlazePose()


def build(cfg: Dict) -> FusedIris:
    return FusedIris(cfg)


def upsampled_1x1(model: FusedIris):
    return dpt.upsampled_1x1(model.depth)


def count_inputs(cfg: Dict) -> Dict[str, tuple]:
    d = cfg["detectors"]
    return {"depth": (1, 3, *cfg["net_hw"]), "blazeface": (1, 3, *d["blazeface"]["input_hw"]),
            "facemesh": (1, 3, *d["facemesh"]["input_hw"]), "blazepose": (1, 3, *d["blazepose"]["input_hw"])}


def _rgb01(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 BGR → (B, 3, H, W) RGB in [0, 1]."""
    return frames_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0


def _resized(rgb: torch.Tensor, size: int, mean: float, std: float) -> torch.Tensor:
    x = F.interpolate(rgb, size=(size, size), mode="bilinear", align_corners=False, antialias=False)
    return (x - mean) / std


def _index(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's index into an axis of n (one wrap of a negative index); one
    numpy would refuse is wrapped again and clamped."""
    i = torch.where(i < 0, i + n, i)
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _at(depth: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    b = torch.arange(depth.shape[0], device=depth.device)
    return depth[b, _index(i, depth.shape[1]), _index(j, depth.shape[2])]


def iris_sample(depth: torch.Tensor, l_centre: torch.Tensor, r_centre: torch.Tensor) -> torch.Tensor:
    """face.py:95-110 with its quirks: int() of the centres, both x clamped to
    shape[0] - 1, the left y slot the clamp of the right y to shape[1] - 1,
    the right y unclamped, ``img[x, y]``; the mean of the two."""
    h, w = depth.shape[1], depth.shape[2]
    lx, rx, ry = (torch.trunc(v).long() for v in (l_centre[:, 0], r_centre[:, 0], r_centre[:, 1]))
    lx, rx, ly = lx.clamp(max=h - 1), rx.clamp(max=h - 1), ry.clamp(max=w - 1)
    return (_at(depth, lx, ly) + _at(depth, rx, ry)) / 2


def points_sample(depth: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """face.py:111-114: the mean of ``img[p[0], p[1]]`` at two int points (B, 2, 2)."""
    pts = pts.long()
    return (_at(depth, pts[:, 0, 0], pts[:, 0, 1]) + _at(depth, pts[:, 1, 0], pts[:, 1, 1])) / 2


def enclosing_circle(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.minEnclosingCircle of each set of a few int points (B, N, 2) →
    centre (B, 2), radius (B,), float32: the smallest of the circles on two
    points as a diameter and the circumcircles of three that holds every
    point (to 1e-9 of its radius), computed in float64."""
    p = points.to(torch.float64)
    n = p.shape[1]
    centres, radii = [], []
    for i, j in itertools.combinations(range(n), 2):
        centres.append((p[:, i] + p[:, j]) / 2)
        radii.append(torch.sqrt(((p[:, i] - p[:, j]) ** 2).sum(-1)) / 2)
    for i, j, k in itertools.combinations(range(n), 3):
        a, b, c = p[:, i], p[:, j], p[:, k]
        d = 2 * (a[:, 0] * (b[:, 1] - c[:, 1]) + b[:, 0] * (c[:, 1] - a[:, 1]) + c[:, 0] * (a[:, 1] - b[:, 1]))
        a2, b2, c2 = (a ** 2).sum(-1), (b ** 2).sum(-1), (c ** 2).sum(-1)
        safe = torch.where(d == 0, torch.ones_like(d), d)
        ux = (a2 * (b[:, 1] - c[:, 1]) + b2 * (c[:, 1] - a[:, 1]) + c2 * (a[:, 1] - b[:, 1])) / safe
        uy = (a2 * (c[:, 0] - b[:, 0]) + b2 * (a[:, 0] - c[:, 0]) + c2 * (b[:, 0] - a[:, 0])) / safe
        u = torch.stack([ux, uy], -1)
        centres.append(u)
        radii.append(torch.where(d == 0, torch.full_like(d, math.inf), torch.sqrt(((a - u) ** 2).sum(-1))))
    centres, radii = torch.stack(centres, 1), torch.stack(radii, 1)  # (B, candidates, 2), (B, candidates)
    dist = torch.sqrt(((centres[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1))
    holds = (dist <= radii[..., None] * (1 + 1e-9) + 1e-9).all(-1)
    best = torch.where(holds, radii, torch.full_like(radii, math.inf)).argmin(1)
    b = torch.arange(len(best), device=p.device)
    return centres[b, best].to(torch.float32), radii[b, best].to(torch.float32)


def on_scale(sample, cfg: Dict):
    """A depth sample (B,) served beside the configuration's ``sample_scale``
    as (B, 2): ``max_scaled_err`` then reads its error on the scale of the
    map it was taken from (the scale ``vis_u8``'s check has), not on its own
    value, which may lie near 0. Works on tensors and numpy values."""
    if isinstance(sample, torch.Tensor):
        return torch.stack([sample, torch.full_like(sample, cfg["sample_scale"])], -1)
    return np.stack([sample, np.full_like(sample, cfg["sample_scale"])], -1)


def decode_vis(vis_u8):
    """The depth's own wrap-around u8 cast that an output frame's byte
    encodes: ``to_video_frame`` is (5·c + 10) mod 256 of the cast c, and 205
    is 5's inverse modulo 256. Works on numpy arrays and tensors of uint8."""
    return (vis_u8 - 10) * 205


def best_logits(net: BlazeFace, frames_u8: torch.Tensor) -> torch.Tensor:
    """BlazeFace's best raw logit (before the clip) on each (B, H, W, 3) u8
    BGR frame, float32 with TF32 off."""
    with torch.inference_mode(), ref.matmul_precision(False):
        _raw, logits = net(_resized(_rgb01(frames_u8), FACE_HW, 0.5, 0.5))
    return logits.max(dim=1).values


def score_biased(cfg: Dict, seed: int, frames, device) -> Dict:
    """``cfg`` with its score heads' bias set from the seed, by the rule of
    ``detectors.blazeface.score_bias``: the seed's first ``pool_frames``
    frames (``frames``, the run's ``frames.Frames``: one each pool frame
    where that is 16) through this BlazeFace on the seed's weights, their
    best logits sorted, the value at ``rank`` (0-based, between two ranks
    the line through them) moved to the logit of ``score`` by a shift of
    each of ``heads``' biases (a ``weights.heads`` entry each). A rank of
    7.5 of 16 puts the threshold midway between the eighth and ninth: eight
    pool frames hit and eight miss, each at least half their gap from it.
    The program and the reference then draw the same weights from the
    returned configuration."""
    from portbench.weights import make_weights

    rule = cfg["detectors"]["blazeface"]["score_bias"]
    n, rank, score = int(rule["pool_frames"]), float(rule["rank"]), float(rule["score"])
    state = make_weights(cfg, seed, device)
    with torch.device("meta"):
        net = BlazeFace()
    net = net.to_empty(device=device)
    net.load_state_dict({k[len("blazeface."):]: v for k, v in state.items() if k.startswith("blazeface.")})
    del state
    first = torch.from_numpy(frames.stack(range(n))).to(device)
    best = best_logits(net.eval(), first).double().sort().values
    lo = min(int(math.floor(rank)), n - 1)
    hi = min(lo + 1, n - 1)
    at = float(best[lo] + (rank - lo) * (best[hi] - best[lo]))
    shift = math.log(score / (1.0 - score)) - at
    out = copy.deepcopy(cfg)
    out["weights"]["heads"] = [*out["weights"]["heads"], *({"param": p, "bias": shift} for p in rule["heads"])]
    return out


def outputs(model: FusedIris, frames_u8: torch.Tensor, cfg: Dict, given: Optional[Dict[str, torch.Tensor]],
            tf32: bool = False) -> Dict[str, torch.Tensor]:
    h, w = frames_u8.shape[1], frames_u8.shape[2]
    thr = float(cfg["detectors"]["blazeface"]["min_detection_con"])
    dev = frames_u8.device
    depth = ref.depth_maps(model.depth, frames_u8, cfg, tf32=tf32)
    rgb = _rgb01(frames_u8)
    boxes, scores = decode(*model.blazeface(_resized(rgb, FACE_HW, 0.5, 0.5)), face_anchors(dev))
    best_score = scores.max(dim=1).values
    hit = best_score >= thr if given is None else given["valid"].to(torch.bool)
    box = best_detection(boxes, scores, hit, thr)
    x0, x1, y0, y1 = crop_box(box if given is None else given["boxes"].to(torch.float32), h, w)
    face = bilinear(rgb, x0[:, None] + _centres(MESH_HW, x1 - x0, dev), y0[:, None] + _centres(MESH_HW, y1 - y0, dev),
                    x0, x1 - 1, y0, y1 - 1)
    crop_pts, mesh_score = model.facemesh(face)
    mesh = torch.stack([x0[:, None] + crop_pts[..., 0] * ((x1 - x0) / MESH_HW)[:, None],
                        y0[:, None] + crop_pts[..., 1] * ((y1 - y0) / MESH_HW)[:, None]], -1)
    int_mesh = torch.trunc(mesh).long() if given is None else given["mesh"].long()
    (l_c, l_r), (r_c, r_r) = (enclosing_circle(int_mesh[:, list(idx)]) for idx in (LEFT_IRIS, RIGHT_IRIS))
    pose_lm, pose_score = model.blazepose(_resized(rgb, POSE_HW, 0.0, 1.0))

    def on_hit(t):
        return torch.where(hit.reshape(-1, *([1] * (t.dim() - 1))), t, torch.zeros_like(t))

    def on_miss(t):
        return torch.where(hit.reshape(-1, *([1] * (t.dim() - 1))), torch.zeros_like(t), t)

    mesh, mesh_score, l_c, l_r, r_c, r_r = (on_hit(t) for t in (mesh, mesh_score, l_c, l_r, r_c, r_r))
    pose_lm, pose_score = on_miss(pose_lm), on_miss(pose_score)
    served_lm = pose_lm if given is None else given["pose_lm"].to(torch.float32)
    ears = torch.stack([torch.trunc(served_lm[:, list(BODY_HEAD), 0] * (w / POSE_HW)),
                        torch.trunc(served_lm[:, list(BODY_HEAD), 1] * (h / POSE_HW))], -1)
    fallback = (torch.zeros((len(hit), 2, 2), dtype=torch.int64, device=dev) if given is None
                else given["fallback_pts"].long())
    samples = {"iris_sample": iris_sample(depth, l_c, r_c), "fallback_sample": points_sample(depth, fallback),
               "ears_sample": points_sample(depth, ears)}
    return {"vis_u8": depth, "valid": best_score, "boxes": box, "mesh": mesh, "mesh_score": mesh_score,
            "l_center": l_c, "l_radius": l_r, "r_center": r_c, "r_radius": r_r,
            "pose_lm": pose_lm, "pose_score": pose_score, "fallback_pts": fallback,
            **{k: on_scale(v, cfg) for k, v in samples.items()}}
