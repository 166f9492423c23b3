"""FaceDetector — the reference's depth_by_detection.py API on the port's
detector nets (JAX ``detect/face_detector.py``).

``findFaces(img, draw, detection) -> (img, bboxs)`` with MediaPipe-style
bbox dicts, ``findIris(img) -> mesh_points | None`` and ``findBody(img) ->
(img, head_pts)``, on a ``PersonDetector`` with no ``FaceDet`` to fill.

The reference's ``FaceDetector.findIris`` computes ``imgRGB`` and then
feeds the BGR frame to the mesh model (depth_by_detection.py:67-75):
``faithful=True`` (the default) keeps that feed, the frame's BGR bytes
/255; ``faithful=False`` feeds the RGB frame.

Weights: as ``PersonDetector``'s. Built without ``params`` it loads the
MediaPipe ``.tflite`` files staged in the cache
(``import_weights --tflite``, ``detect/weights.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
from depth_estimation_tpu_torch.device import full_f32
from depth_estimation_tpu_torch.ops.sampling import bgr_u8_to_rgb01, to_int32, u8_to_01
from depth_estimation_tpu_torch.runtime.fused import blazeface_branch, crop_box, mesh_points


class _NullFace:
    """Standalone use: no FaceDet to fill."""

    def __init__(self):
        self.mesh = None
        self.l_iris = {"center": None, "radius": None}
        self.r_iris = {"center": None, "radius": None}


class FaceDetector:
    def __init__(self, minDetectionCon: float = 0.2, params: Optional[Dict] = None, seed: int = 0,
                 faithful: bool = True, device="cuda"):
        """params: ``PersonDetector``'s {"blazeface", "facemesh",
        "blazepose_detector", "blazepose"} state dicts; None loads the
        MediaPipe ``.tflite`` files staged in the cache through
        ``PersonDetector`` (``detect/weights.py``), with random nets from
        ``seed`` for those it finds no file for."""
        self._impl = PersonDetector(_NullFace(), minDetectionCon, params=params, seed=seed, device=device)
        self.minDetectionCon = minDetectionCon
        self.faithful = faithful
        self.device = self._impl.device
        self.results = None
        self.w: Optional[int] = None
        self.h: Optional[int] = None

    def _detect(self, img: np.ndarray):
        """One staged BlazeFace program → host (boxes, scores, valid) of the frame."""
        impl = self._impl
        with torch.inference_mode(), full_f32():
            out = blazeface_branch(impl._face_det, impl._face_anchors, self.minDetectionCon, impl._frame(img))
        return tuple(t[0].cpu().numpy() for t in out)

    def findFaces(self, img: np.ndarray, draw: bool = True, detection=None):
        """Face bboxes with id/score/center dicts (depth_by_detection.py:32-60).

        ``detection``: (boxes, scores, valid) that the detection program
        already made (``FusedDetectionRunner``); without it one staged
        BlazeFace program runs."""
        h, w = img.shape[:2]
        if detection is None:
            detection = self._detect(img)
        boxes, scores, valid = (np.asarray(a) for a in detection)
        bboxs = []
        for i in range(len(scores)):
            if not valid[i]:
                continue
            ymin, xmin, ymax, xmax = boxes[i, :4]
            bbox = (int(xmin * w), int(ymin * h), int((xmax - xmin) * w), int((ymax - ymin) * h))
            cx = bbox[0] + bbox[2] // 2
            cy = bbox[1] + bbox[3] // 2
            bboxs.append({"id": len(bboxs), "bbox": bbox, "score": [float(scores[i])], "center": (cx, cy)})
            if draw:
                self._draw_box(img, bbox, float(scores[i]))
        self.results = bboxs
        return img, bboxs

    def findIris(self, img: np.ndarray):
        """Single-person mesh points (478, 2) int in frame pixels, or None
        (depth_by_detection.py:62-82): a staged BlazeFace program, then, on a
        hit, FaceMesh+iris on the face crop (``crop_box``) of the BGR frame
        when faithful, of the RGB frame otherwise."""
        self.h, self.w = img.shape[:2]
        impl = self._impl
        frames = impl._frame(img)
        with torch.inference_mode(), full_f32():
            boxes, _scores, valid = blazeface_branch(impl._face_det, impl._face_anchors, self.minDetectionCon, frames)
            if not bool(valid[0, 0]):
                return None
            points, _score = mesh_points(impl._mesh, frames, *crop_box(boxes, self.h, self.w),
                                         pixels=u8_to_01 if self.faithful else bgr_u8_to_rgb01)
        return to_int32(points)[0].cpu().numpy().astype(int)

    def findBody(self, img: np.ndarray):
        return self._impl.findBody(img)

    def body_from_fused(self, img: np.ndarray, lm, score):
        """findBody's host half on pose landmarks that the detection program
        already made (tier 3)."""
        return self._impl.body_from_fused(img, lm, score)

    def _draw_box(self, img, bbox, score):
        try:
            import cv2

            cv2.rectangle(img, bbox, (255, 0, 255), 2)
            cv2.putText(img, f"{int(score * 100)}%", (bbox[0], bbox[1] - 20),
                        cv2.FONT_HERSHEY_PLAIN, 2, (255, 0, 255), 2)
        except ImportError:
            pass
