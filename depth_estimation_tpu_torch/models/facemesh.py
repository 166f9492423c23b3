"""FaceMesh + iris landmark networks (JAX ``models/facemesh.py``), NCHW.

* ``FaceMesh``: a 192×192 face crop → 468×3 landmarks in crop pixels and a
  face-presence probability;
* ``IrisLandmark``: a 64×64 eye crop → 71×3 eye-contour and 5×3 iris
  landmarks;
* ``FaceMeshWithIris``: what MediaPipe's ``refine_landmarks`` pipeline does:
  the mesh, square eye crops around the eye corners (×2.3, the right eye
  mirrored), one batched iris pass for both eyes, and the 478×3 assembly
  (468 right-iris center, 469-472 its boundary, 473 left center, 474-477).

Module names are the Flax module names (``utils/convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from depth_estimation_tpu_torch.models.layers import Conv2dSame, IrisBlock, MPBlock, PReLU
from depth_estimation_tpu_torch.ops.sampling import crop_resize_bilinear

NUM_LANDMARKS = 478
NUM_MESH_LANDMARKS = 468
INPUT_SIZE = 192
IRIS_INPUT_SIZE = 64
RIGHT_EYE_CORNERS = (33, 133)  # subject-right eye = image-left (outer, inner)
LEFT_EYE_CORNERS = (362, 263)  # subject-left eye (inner, outer)
_ROI_SCALE = 2.3
MESH_PLAN = ((16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1),
             (128, 2), (128, 1), (128, 1), (128, 2), (128, 1), (128, 1))


def _add(module: nn.Module, name: str, child: nn.Module, names: list) -> None:
    module.add_module(name, child)
    names.append(name)


def _run(module: nn.Module, names, h):
    for name in names:
        h = getattr(module, name)(h)
    return h


class FaceMesh(nn.Module):
    """(B, 3, 192, 192) in [0, 1] → (landmarks (B, 468, 3), probability (B,)).
    Backbone down to 6×6×128; two heads (landmarks, face flag), each
    block(s2) → 1×1 conv to 32 + PReLU → block → 3×3 VALID conv to 1×1."""

    def __init__(self):
        super().__init__()
        self.stem = Conv2dSame(3, 16, 3, 2, bias=True)
        self.stem_act = PReLU(16)
        self.blocks, c = [], 16
        for i, (w, s) in enumerate(MESH_PLAN):
            _add(self, f"block_{i}", MPBlock(c, w, s), self.blocks)
            c = w
        self.heads = {}
        for tag, out in (("coord", NUM_MESH_LANDMARKS * 3), ("conf", 1)):
            names = self.heads[tag] = []
            _add(self, f"{tag}_block_a", MPBlock(128, 128, 2), names)
            _add(self, f"{tag}_conv", nn.Conv2d(128, 32, 1), names)
            _add(self, f"{tag}_act", PReLU(32), names)
            _add(self, f"{tag}_block_b", MPBlock(32, 32), names)
            _add(self, f"{tag}_out", nn.Conv2d(32, out, 3), names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = _run(self, self.blocks, self.stem_act(self.stem(x)))
        lm = _run(self, self.heads["coord"], h).reshape(-1, NUM_MESH_LANDMARKS, 3)
        score = _run(self, self.heads["conf"], h).reshape(-1)
        return lm, torch.reciprocal(1.0 + torch.exp(-score))


class IrisLandmark(nn.Module):
    """(B, 3, 64, 64) in [0, 1] → (eye contour (B, 71, 3), iris (B, 5, 3))
    in crop pixels: a shared backbone to 8×8×128, then two branches down to
    1×1 and a 2×2 VALID conv each."""

    def __init__(self):
        super().__init__()
        self.stem = Conv2dSame(3, 64, 3, 2, bias=True)
        self.stem_act = PReLU(64)
        self.backbone = []
        plan = ([("back_a_%d" % i, 64, 64, 1) for i in range(4)] + [("back_down1", 64, 128, 2)]
                + [("back_b_%d" % i, 128, 128, 1) for i in range(4)] + [("back_down2", 128, 128, 2)]
                + [("back_c_%d" % i, 128, 128, 1) for i in range(4)])
        for name, cin, cout, s in plan:
            _add(self, name, IrisBlock(cin, cout, s), self.backbone)
        self.branches = {}
        for tag, out in (("eye", 71 * 3), ("iris", 5 * 3)):
            names = self.branches[tag] = []
            for part, s in (("down1", 2), ("a", 1), ("b", 1), ("down2", 2), ("c", 1), ("d", 1)):
                _add(self, f"{tag}_{part}", IrisBlock(128, 128, s), names)
            _add(self, f"{tag}_out", nn.Conv2d(128, out, 2), names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = _run(self, self.backbone, self.stem_act(self.stem(x)))
        eye = _run(self, self.branches["eye"], h).reshape(-1, 71, 3)
        iris = _run(self, self.branches["iris"], h).reshape(-1, 5, 3)
        return eye, iris


def _eye_rois(lm: torch.Tensor, corners: Tuple[int, int], crop_size: float):
    """Square ROIs (x0, y0, side), each (B,), around an eye from its corner
    landmarks, scaled ×2.3, clamped inside the face crop."""
    p0, p1 = lm[:, corners[0], :2], lm[:, corners[1], :2]
    center = (p0 + p1) / 2.0
    side = torch.clamp(torch.linalg.vector_norm(p1 - p0, dim=-1) * _ROI_SCALE, 8.0, crop_size)
    x0 = torch.clamp(center[:, 0] - side / 2.0, min=0.0).minimum(crop_size - side)
    y0 = torch.clamp(center[:, 1] - side / 2.0, min=0.0).minimum(crop_size - side)
    return x0, y0, side


class FaceMeshWithIris(nn.Module):
    """(B, 3, 192, 192) in [0, 1] → (landmarks (B, 478, 3) in crop pixels,
    face-presence probability (B,))."""

    def __init__(self):
        super().__init__()
        self.mesh = FaceMesh()
        self.iris = IrisLandmark()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lm, score = self.mesh(x)
        b = x.shape[0]
        rois = [_eye_rois(lm, c, float(INPUT_SIZE)) for c in (RIGHT_EYE_CORNERS, LEFT_EYE_CORNERS)]
        nhwc = x.permute(0, 2, 3, 1)
        out_hw = (IRIS_INPUT_SIZE, IRIS_INPUT_SIZE)
        r_crop, l_crop = (crop_resize_bilinear(nhwc, torch.stack(roi, dim=-1), out_hw) for roi in rois)
        eyes = torch.cat([r_crop.flip(2), l_crop], dim=0).permute(0, 3, 1, 2)  # right eye mirrored
        _contour, iris = self.iris(eyes.contiguous())
        r_iris, l_iris = iris[:b], iris[b:]
        r_iris = torch.stack([IRIS_INPUT_SIZE - r_iris[..., 0], r_iris[..., 1], r_iris[..., 2]], dim=-1)

        def to_crop(pts, roi):
            x0, y0, side = roi
            s = (side / IRIS_INPUT_SIZE)[:, None]
            return torch.stack([x0[:, None] + pts[..., 0] * s, y0[:, None] + pts[..., 1] * s, pts[..., 2] * s],
                               dim=-1)

        return torch.cat([lm, to_crop(r_iris, rois[0]), to_crop(l_iris, rois[1])], dim=1), score
