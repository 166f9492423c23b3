"""PersonDetector — the reference's detectors.py API on the port's detector
nets (JAX ``detect/person_detector.py``).

The landmark index tables, ``findIris(img)`` filling ``face.mesh`` and the
two iris circles, ``findBody(img) -> (img, head_pts)``, ``visualize(img)``,
and the fused program's host halves ``set_fused_mesh`` and
``body_from_fused``. ``findIris`` and ``findBody`` are the staged calls: each
runs its nets on one frame through the fused program's own branch functions
(``runtime/fused.py``), then fits the iris circles on the host as the
reference does. The streaming loop runs the fused program instead.

Weights: ``params=None`` loads the MediaPipe ``.tflite`` files staged in the
cache (``detect/weights.py``: ``$DEPTH_ESTIMATION_TPU_TORCH_CACHE/tflite/``,
converted once and cached), and gives the nets that it finds no file for
random weights from ``seed`` (pipeline-valid, numerically meaningless), with
a warning that names them; ``params={"blazeface": sd, "facemesh": sd,
"blazepose_detector": sd, "blazepose": sd}`` takes state dicts of the port's
nets, such as the converters of ``utils/convert.py`` make from ``.tflite``
files or from the JAX package's trees (a key left out: random weights).
"""

from __future__ import annotations

import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from depth_estimation_tpu_torch.config import BODY_HEAD, CARD, HEAD, LEFT_EYE, LEFT_IRIS, RIGHT_EYE, RIGHT_IRIS
from depth_estimation_tpu_torch.detect.anchors import BLAZEFACE_FRONT, BLAZEPOSE_DETECTOR, build_anchors
from depth_estimation_tpu_torch.detect.circle import min_enclosing_circle
from depth_estimation_tpu_torch.device import full_f32, resolve_device
from depth_estimation_tpu_torch.estimator import random_state_dict
from depth_estimation_tpu_torch.models.blazeface import BlazeFace
from depth_estimation_tpu_torch.models.blazepose import BlazePose, BlazePoseDetector
from depth_estimation_tpu_torch.models.facemesh import FaceMeshWithIris
from depth_estimation_tpu_torch.runtime.fused import (blazeface_branch, crop_box, mesh_points, pose_branch,
                                                      pose_detector_branch, to_int32)

# (params key, net, seed offset): the JAX detector's seeds
_NETS = (("blazeface", BlazeFace, 0), ("facemesh", FaceMeshWithIris, 1), ("blazepose_detector", BlazePoseDetector, 2),
         ("blazepose", BlazePose, 3))


def _load(make, sd: Optional[Mapping], seed: int, device: torch.device) -> torch.nn.Module:
    with torch.device("meta"):
        net = make()
    if sd is None:
        sd = random_state_dict(net, seed)
    net = net.to_empty(device=device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                         for k, v in sd.items()})
    return net.eval()


class PersonDetector:
    """Find a single person's face mesh, irises and body pose.

    :param face: the ``FaceDet`` that findIris fills (detectors.py:62-64)
    :param minDetectionCon: detection threshold (detectors.py:12)
    """

    def __init__(self, face, minDetectionCon: float = 0.2, params: Optional[Dict] = None, seed: int = 0,
                 device="cuda"):
        self.LEFT_EYE = list(LEFT_EYE)
        self.RIGHT_EYE = list(RIGHT_EYE)
        self.LEFT_IRIS = list(LEFT_IRIS)
        self.RIGHT_IRIS = list(RIGHT_IRIS)
        self.HEAD = list(HEAD)
        self.BODY_HEAD = list(BODY_HEAD)
        self.CARD = list(CARD)

        self.minDetectionCon = minDetectionCon
        self.results = None
        self.w: Optional[int] = None
        self.h: Optional[int] = None
        self.body_mesh = None
        self.face = face
        self.device = resolve_device(device)
        if params is None:
            from depth_estimation_tpu_torch.detect.weights import load_detector_params

            params = load_detector_params()
            missing = [key for key, _make, _off in _NETS if key not in params]
            if missing:
                warnings.warn(f"No detector weights in the cache for {missing}; using random initialization "
                              f"(seed {seed}).", stacklevel=2)
        self._face_det, self._mesh, self._pose_det, self._pose = (
            _load(make, params.get(key), seed + off, self.device) for key, make, off in _NETS)
        self._face_anchors = torch.from_numpy(build_anchors(BLAZEFACE_FRONT)).to(self.device)
        self._pose_anchors = torch.from_numpy(build_anchors(BLAZEPOSE_DETECTOR)).to(self.device)

    def _frame(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img)[None]).to(self.device)

    def _detect_fn(self, in_hw: Tuple[int, int], kind: str):
        """JAX ``_detect_fn``: the detector stage of ``kind`` ("face":
        BlazeFace at ``minDetectionCon``; "pose": BlazePoseDetector at 0.5)
        as fn(img_u8 (H, W, 3) BGR, numpy or a tensor) → the frame's
        weighted-NMS (boxes (16, 16 or 12), scores (16,), valid (16,)) on the
        device."""
        h, w = int(in_hw[0]), int(in_hw[1])

        def fn(img_u8):
            if tuple(img_u8.shape[:2]) != (h, w):
                raise ValueError(f"a frame of {tuple(img_u8.shape[:2])} given to the {(h, w)} detector")
            frames = (img_u8 if isinstance(img_u8, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img_u8))
                      )[None].to(self.device)
            with torch.inference_mode(), full_f32():
                if kind == "face":
                    out = blazeface_branch(self._face_det, self._face_anchors, self.minDetectionCon, frames)
                else:
                    out = pose_detector_branch(self._pose_det, self._pose_anchors, frames)
            return tuple(t[0] for t in out)

        return fn

    # -- public API (reference-compatible) ----------------------------------

    def findIris(self, img: np.ndarray) -> None:
        """Detect the irises of a single person (detectors.py:42-64). On a
        hit writes ``face.mesh`` (478×2 int frame pixels) and both iris
        circles; on a miss leaves ``face.mesh`` as it is. The face crop is
        the fused program's ``crop_box`` (the JAX ``_best_face_box``)."""
        self.h, self.w = img.shape[:2]
        frames = self._frame(img)
        with torch.inference_mode(), full_f32():
            boxes, _scores, valid = blazeface_branch(self._face_det, self._face_anchors, self.minDetectionCon, frames)
            if not bool(valid[0, 0]):
                self.results = None
                return
            points, score = mesh_points(self._mesh, frames, *crop_box(boxes, self.h, self.w))
        mesh = to_int32(points)[0].cpu().numpy().astype(int)
        self.results = {"landmarks": mesh, "score": float(score[0])}
        self.face.mesh = mesh
        self.face.l_iris["center"], self.face.l_iris["radius"] = min_enclosing_circle(mesh[self.LEFT_IRIS])
        self.face.r_iris["center"], self.face.r_iris["radius"] = min_enclosing_circle(mesh[self.RIGHT_IRIS])

    def set_fused_mesh(self, img: np.ndarray, mesh, score, l_center, l_radius, r_center, r_radius,
                       found: bool) -> None:
        """Fill the face state from the fused program's outputs (mesh in frame
        pixels, both circles fitted on the device). On ``found=False`` leaves
        ``face.mesh`` as it is, as findIris does on a miss."""
        self.h, self.w = img.shape[:2]
        if not found:
            self.results = None
            return
        mesh = np.asarray(mesh)
        self.results = {"landmarks": mesh, "score": float(score)}
        self.face.mesh = mesh
        l_c = np.asarray(l_center, dtype=np.float64)
        r_c = np.asarray(r_center, dtype=np.float64)
        self.face.l_iris["center"], self.face.l_iris["radius"] = (float(l_c[0]), float(l_c[1])), float(l_radius)
        self.face.r_iris["center"], self.face.r_iris["radius"] = (float(r_c[0]), float(r_c[1])), float(r_radius)

    def findBody(self, img: np.ndarray):
        """Body pose; returns (img, head_pts), the ear landmarks 7 and 8 in
        frame pixels (detectors.py:67-106)."""
        with torch.inference_mode(), full_f32():
            lm, score = pose_branch(self._pose, self._frame(img))
        return self.body_from_fused(img, lm[0].cpu().numpy(), float(score[0]))

    def body_from_fused(self, img: np.ndarray, lm, score):
        """findBody's host half on pose landmarks already computed: the
        256-crop landmarks scaled to the frame, ear points drawn, (img,
        head_pts) returned."""
        h, w = img.shape[:2]
        self.h, self.w = self.h or h, self.w or w
        lm = np.asarray(lm)
        xs = lm[:, 0] * (w / 256.0)
        ys = lm[:, 1] * (h / 256.0)
        head_pts = []
        for idx in self.BODY_HEAD:
            center = np.array([int(xs[idx]), int(ys[idx])])
            head_pts.append(center)
            self._draw_point(img, center, str(idx))
        self.results = {"landmarks": lm, "score": float(score)}
        return img, head_pts

    def visualize(self, img: np.ndarray) -> None:
        """Eye polylines, iris circles, head lines and the calibration card
        dots (detectors.py:108-124)."""
        try:
            import cv2
        except ImportError:
            self.frame = img
            return
        mesh = self.face.mesh
        cv2.polylines(img, [mesh[self.LEFT_EYE]], True, (0, 255, 0), 1, cv2.LINE_AA)
        cv2.polylines(img, [mesh[self.RIGHT_EYE]], True, (0, 255, 0), 1, cv2.LINE_AA)
        center_left = np.array(self.face.l_iris["center"], dtype=np.int32)
        center_right = np.array(self.face.r_iris["center"], dtype=np.int32)
        cv2.circle(img, center_left, int(self.face.l_iris["radius"]), (255, 0, 255), 2, cv2.LINE_AA)
        cv2.circle(img, center_right, int(self.face.r_iris["radius"]), (255, 0, 255), 2, cv2.LINE_AA)
        cv2.line(img, mesh[self.HEAD[0]], mesh[self.HEAD[1]], (0, 255, 0), 1, cv2.LINE_AA)
        cv2.line(img, mesh[self.HEAD[2]], mesh[self.HEAD[3]], (0, 255, 0), 1, cv2.LINE_AA)
        cv2.circle(img, tuple(self.CARD[:2]), 1, (255, 0, 255), 2, cv2.LINE_AA)
        cv2.circle(img, tuple(self.CARD[2:]), 1, (255, 0, 255), 2, cv2.LINE_AA)
        self.frame = img

    def _draw_point(self, img, center, label):
        try:
            import cv2

            cv2.circle(img, tuple(int(v) for v in center), 2, (255, 0, 255), 2, cv2.LINE_AA)
            cv2.putText(img, label, (int(center[0]), int(center[1]) - 20),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1, cv2.LINE_AA)
        except ImportError:
            pass
