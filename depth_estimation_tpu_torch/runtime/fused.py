"""The fused iris/pose + depth frame program (JAX ``runtime/fused.py``).

One program a batch of B frames (B = 1 per frame, K in a micro-batch),
from u8 BGR frames already on the device, with no host sync inside:

* depth: ``DepthEstimator.depth_branch`` (K2 cubic → network → K3 cubic,
  f32 map at the source size);
* BlazeFace on K2's linear route to 128² (mean = std = 0.5: ``rgb·2 − 1``),
  decode and weighted NMS;
* the face crop box (JAX ``_best_face_box``'s 25% margin and truncating casts),
  FaceMesh+iris on the 192² crop of the /255 RGB frame, landmarks mapped to
  frame pixels, both iris circles fitted;
* BlazePose on K2's linear route to 256² (mean 0, std 1);
* the output frame (``to_video_frame_u8``) and the three depth samples of
  ``FaceDet.get_depth`` with their quirks.

JAX runs the mesh branch or the pose branch under ``lax.cond`` on a hit
(``valid[0]``). A torch branch on a device value would sync the host, so
both branches run for every frame and ``torch.where`` on ``valid[:, 0]``
keeps one, with JAX's zeros for the other, as JAX's own batched (vmapped)
program does. On a miss the crop box is all zeros, a 1×1 crop, and stays
finite.

On the CPU the kernels' plain versions run, on the card the kernels; the
detector nets run in full f32 (``device.full_f32``) whatever the depth
network's type.

Spans (``runtime/tracing.py``; host enqueue times, recorded only under
``tracing.record()`` or ``trace()``): ``FusedFrameRunner.batched`` is one
``program`` (rows) whose children are ``program.upload`` (frames and
fallback points to the device), the depth branch's ``program.k2``,
``program.network`` and ``program.k3``, ``program.face`` (K2 to 128²,
BlazeFace, decode, NMS), ``program.mesh`` (crop box, crop, FaceMesh+iris,
circle fit, keep), ``program.outputs`` (the output frame, the iris and
fallback samples) and ``program.pose`` (K2 to 256², BlazePose, keep, the
sample at its ears), in the order they are enqueued.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from depth_estimation_tpu_torch.config import BODY_HEAD, LEFT_IRIS, RIGHT_IRIS
from depth_estimation_tpu_torch.detect.anchors import decode_boxes, decode_scores, weighted_nms
from depth_estimation_tpu_torch.detect.circle import min_enclosing_circle_torch
from depth_estimation_tpu_torch.device import full_f32
from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess
from depth_estimation_tpu_torch.ops.postprocess import to_video_frame_u8
from depth_estimation_tpu_torch.ops.sampling import bgr_u8_to_rgb01, crop_resize_bilinear_rect, to_int32, u8_to_01
from depth_estimation_tpu_torch.runtime import tracing

FACE_INPUT, MESH_INPUT, POSE_INPUT, POSE_DETECTOR_INPUT = 128, 192, 256, 224


def _ssd_branch(net, anchors: torch.Tensor, size: int, thresh: float, frames: torch.Tensor):
    """u8 BGR (B, H, W, 3) → an SSD detector's weighted-NMS detections: K2's
    linear route to size² with mean = std = 0.5 (JAX's ``x/127.5 − 1`` of
    the RGB frame, then the linear resize), the net, decode, NMS at IoU 0.3."""
    x = fused_preprocess(frames, (size, size), (0.5,) * 3, (0.5,) * 3, True, "linear")
    raw_boxes, raw_scores = net(x)
    boxes = decode_boxes(raw_boxes, anchors, float(size))
    return weighted_nms(boxes, decode_scores(raw_scores), iou_threshold=0.3, score_threshold=thresh)


def blazeface_branch(face_net, anchors: torch.Tensor, thresh: float, frames: torch.Tensor):
    """u8 BGR (B, H, W, 3) → BlazeFace's weighted-NMS detections: boxes
    (B, 16, 16), scores (B, 16), valid (B, 16)."""
    return _ssd_branch(face_net, anchors, FACE_INPUT, thresh, frames)


def pose_detector_branch(pose_det_net, anchors: torch.Tensor, frames: torch.Tensor):
    """u8 BGR (B, H, W, 3) → BlazePoseDetector's weighted-NMS detections over
    its 2254 anchors at score 0.5 (JAX ``_detect_fn(..., "pose")``): boxes
    (B, 16, 12), scores (B, 16), valid (B, 16). One K2 launch."""
    return _ssd_branch(pose_det_net, anchors, POSE_DETECTOR_INPUT, 0.5, frames)


def crop_box(boxes: torch.Tensor, h: int, w: int):
    """The face crop of each frame's best box, as the JAX ``_best_face_box``: 25%
    margin, ordered clips, truncating casts → x0, x1, y0, y1 (B,) float32."""
    ymin, xmin, ymax, xmax = (boxes[:, 0, i] for i in range(4))
    bw, bh = xmax - xmin, ymax - ymin
    x0 = torch.trunc(((xmin - 0.25 * bw) * w).clamp(0.0, w - 2.0))
    x1 = torch.trunc(torch.maximum((xmax + 0.25 * bw) * w, x0 + 1.0).clamp(max=float(w)))
    y0 = torch.trunc(((ymin - 0.25 * bh) * h).clamp(0.0, h - 2.0))
    y1 = torch.trunc(torch.maximum((ymax + 0.25 * bh) * h, y0 + 1.0).clamp(max=float(h)))
    return x0, x1, y0, y1


def mesh_points(mesh_net, frames: torch.Tensor, x0, x1, y0, y1, pixels=bgr_u8_to_rgb01):
    """FaceMesh+iris on each frame's (x0, y0)–(x1, y1) crop, landmarks mapped
    to frame pixels → points (B, 478, 2) float32, score (B,). ``pixels``
    maps the gathered u8 BGR bytes to the mesh's input: the /255 RGB frame
    (``bgr_u8_to_rgb01``), or the /255 BGR frame (``u8_to_01``), which
    ``FaceDetector`` feeds when faithful. The mesh is the points' truncating
    int cast (``to_int32``), as the host path's ``.astype(int)``."""
    box = torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)
    crop = crop_resize_bilinear_rect(frames, box, (MESH_INPUT, MESH_INPUT), pixels=pixels)
    lm, score = mesh_net(crop.permute(0, 3, 1, 2).contiguous())
    sx, sy = ((x1 - x0) / float(MESH_INPUT))[:, None], ((y1 - y0) / float(MESH_INPUT))[:, None]
    return torch.stack([x0[:, None] + lm[..., 0] * sx, y0[:, None] + lm[..., 1] * sy], dim=-1), score


def pose_branch(pose_net, frames: torch.Tensor):
    """BlazePose on the whole /255 RGB frame resized to 256² (the staged
    ``findBody``'s input) → landmarks (B, 33, 5), score (B,)."""
    return pose_net(fused_preprocess(frames, (POSE_INPUT, POSE_INPUT), (0.0,) * 3, (1.0,) * 3, True, "linear"))


def _np_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """The JAX program's index into a depth axis of n: its helper wraps a
    negative index once, ``jnp`` indexing wraps a still-negative one again,
    and the gather clamps into [0, n - 1] (where numpy would raise). Spelled
    out: out of range on CUDA is a device-side assert."""
    i = torch.where(i < 0, i + n, i)
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1)


def _at(depth: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """depth (B, H, W) at one (i, j) a frame, transposed indexing kept."""
    b = torch.arange(depth.shape[0], device=depth.device)
    return depth[b, _np_index(i.long(), depth.shape[1]), _np_index(j.long(), depth.shape[2])]


def sample_iris_depth(depth: torch.Tensor, l_c: torch.Tensor, r_c: torch.Tensor) -> torch.Tensor:
    """``FaceDet.get_depth``'s iris sample (face.py:91-116) with its quirks:
    truncating casts, x clamped to shape[0] - 1, the left y slot holding the
    clamp of the right y (itself never clamped), ``img[x, y]`` indexing."""
    h, w = depth.shape[1], depth.shape[2]
    lx, rx, ry = to_int32(l_c[:, 0]), to_int32(r_c[:, 0]), to_int32(r_c[:, 1])
    lx, rx, ly = lx.clamp(max=h - 1), rx.clamp(max=h - 1), ry.clamp(max=w - 1)
    return (_at(depth, lx, ly) + _at(depth, rx, ry)) / 2.0


def sample_pts_depth(depth: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``FaceDet.get_depth``'s body-fallback sample at points (B, 2, 2) as
    stored: ``img[p[0], p[1]]``."""
    return (_at(depth, pts[:, 0, 0], pts[:, 0, 1]) + _at(depth, pts[:, 1, 0], pts[:, 1, 1])) / 2.0


def _keep(hit: torch.Tensor, t: torch.Tensor, on_hit: bool) -> torch.Tensor:
    """t where the frame's branch ran (hit for the mesh, miss for the pose), else zeros."""
    mask = hit.reshape(-1, *([1] * (t.dim() - 1)))
    zeros = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(mask, t, zeros) if on_hit else torch.where(mask, zeros, t)


def make_fused_frame_fn(estimator, detector, in_hw: Tuple[int, int]):
    """JAX ``make_fused_frame_fn``: depth plus BlazeFace and its NMS in one
    program on B frames of u8 BGR already on the device → ``depth`` (B, H,
    W) f32, ``boxes`` (B, 16, 16), ``scores`` (B, 16), ``valid`` (B, 16).
    The ``mesh=False`` runner's program: K2 cubic and linear (128²), the
    network, K3."""
    h, w = int(in_hw[0]), int(in_hw[1])

    def fused(frames: torch.Tensor):
        if tuple(frames.shape[1:3]) != (h, w):
            raise ValueError(f"frames of {tuple(frames.shape[1:3])} given to the {(h, w)} program")
        with torch.inference_mode(), estimator._numerics(), full_f32():
            depth = estimator.depth_branch(frames)
            return (depth, *blazeface_branch(detector._face_det, detector._face_anchors, detector.minDetectionCon,
                                             frames))

    return fused


def make_fused_iris_frame_fn(estimator, detector, in_hw: Tuple[int, int], include_pose: bool = True,
                             emit_depth_map: bool = True):
    """JAX ``make_fused_iris_frame_fn`` for B frames: fn(frames (B, H, W, 3)
    u8 on the device, fallback_pts (B, 2, 2) int32) → a dict of (B, …)
    tensors: ``depth`` (H, W) f32 (only when ``emit_depth_map``), ``boxes``
    (16, 16), ``scores`` (16,), ``valid`` (16,), ``mesh`` (478, 2) int32
    frame pixels, ``mesh_score``, ``l_center`` (2,), ``l_radius``,
    ``r_center``, ``r_radius``, ``vis_u8`` (H, W), ``iris_sample``,
    ``fallback_sample`` (at the stored head points) and, when
    ``include_pose`` (the port's default; JAX's is False), ``pose_lm`` (33,
    5) in 256-crop units, ``pose_score`` and ``ears_sample`` (at this
    frame's pose ears). Mesh fields are zeros on a miss, pose fields on a
    hit; the samples are taken at the zeros all the same. Without the pose
    the miss branch is the mesh zeros alone and K2's 256² launch is not
    made; without the depth map the program computes the same and returns
    less."""
    h, w = int(in_hw[0]), int(in_hw[1])
    dev = estimator.device
    iris_idx = torch.tensor([LEFT_IRIS, RIGHT_IRIS], device=dev)  # (2 eyes, 4 points)
    ears_idx = torch.tensor(BODY_HEAD, device=dev)

    def fused(frames: torch.Tensor, fallback_pts: torch.Tensor) -> Dict[str, torch.Tensor]:
        if tuple(frames.shape[1:3]) != (h, w):
            raise ValueError(f"frames of {tuple(frames.shape[1:3])} given to the {(h, w)} program")
        with torch.inference_mode(), estimator._numerics(), full_f32():
            depth = estimator.depth_branch(frames)
            with tracing.span("program.face"):
                boxes, scores, valid = blazeface_branch(detector._face_det, detector._face_anchors,
                                                        detector.minDetectionCon, frames)
            hit = valid[:, 0]
            with tracing.span("program.mesh"):
                points, mesh_score = mesh_points(detector._mesh, frames, *crop_box(boxes, h, w))
                mesh = to_int32(points)
                centers, radii = min_enclosing_circle_torch(mesh[:, iris_idx].float())  # both eyes in one fit
                l_c, r_c, l_r, r_r = centers[:, 0], centers[:, 1], radii[:, 0], radii[:, 1]
                mesh, mesh_score, l_c, l_r, r_c, r_r = (_keep(hit, t, True) for t in (mesh, mesh_score, l_c, l_r,
                                                                                       r_c, r_r))
            with tracing.span("program.outputs"):
                out = {"depth": depth} if emit_depth_map else {}
                out.update({
                    "boxes": boxes, "scores": scores, "valid": valid,
                    "mesh": mesh, "mesh_score": mesh_score, "l_center": l_c, "l_radius": l_r,
                    "r_center": r_c, "r_radius": r_r,
                    "vis_u8": to_video_frame_u8(depth),
                    "iris_sample": sample_iris_depth(depth, l_c, r_c),
                    "fallback_sample": sample_pts_depth(depth, fallback_pts),
                })
            if include_pose:
                with tracing.span("program.pose"):
                    pose_lm, pose_score = pose_branch(detector._pose, frames)
                    pose_lm, pose_score = _keep(hit, pose_lm, False), _keep(hit, pose_score, False)
                    # this frame's ear pixels, mapped as body_from_fused maps them
                    ears = torch.stack([to_int32(pose_lm[:, ears_idx, 0] * (w / 256.0)),
                                        to_int32(pose_lm[:, ears_idx, 1] * (h / 256.0))], dim=-1)
                    out.update(pose_lm=pose_lm, pose_score=pose_score, ears_sample=sample_pts_depth(depth, ears))
            return out

    return fused


class FusedFrameRunner:
    """JAX ``FusedFrameRunner``: caches the program per source size.

    ``mesh=True`` (default): the fused iris program, with BlazePose as the
    miss branch when ``pose`` (default; needs ``mesh``); ``__call__`` runs
    one frame and ``batched`` K frames through the same program (B = 1 or
    K). ``emit_depth_map=False`` drops the f32 map from the outputs (the
    servers' setting: ``vis_u8`` and the samples stay). ``mesh=False``: the
    depth + BlazeFace program (``make_fused_frame_fn``), whose ``__call__``
    returns one frame's ``(depth, boxes, scores, valid)``; its ``batched``
    raises, as JAX's does."""

    def __init__(self, estimator, detector, mesh: bool = True, pose: bool = True, emit_depth_map: bool = True):
        self.estimator = estimator
        self.detector = detector
        self.mesh = bool(mesh)
        self.pose = self.mesh and bool(pose)
        self.emit_depth_map = bool(emit_depth_map)
        self._cache = {}

    def _program(self, hw):
        hw = (int(hw[0]), int(hw[1]))
        if hw not in self._cache:
            self._cache[hw] = (make_fused_iris_frame_fn(self.estimator, self.detector, hw, self.pose,
                                                        self.emit_depth_map) if self.mesh
                               else make_fused_frame_fn(self.estimator, self.detector, hw))
        return self._cache[hw]

    def batched(self, imgs_u8, fallback_pts=None) -> Dict[str, torch.Tensor]:
        """(K, H, W, 3) u8 BGR frames, numpy or a tensor; ``fallback_pts``
        an optional (K, 2, 2) int array of stored head points. Mesh mode
        only."""
        if not self.mesh:
            raise ValueError("batched dispatch requires mesh=True")
        with tracing.span("program", rows=len(imgs_u8)):
            with tracing.span("program.upload"):
                frames = self.estimator._to_device(imgs_u8)
                k = frames.shape[0]
                pts = np.zeros((k, 2, 2), np.int32) if fallback_pts is None else np.asarray(fallback_pts, np.int32)
                pts = torch.from_numpy(np.ascontiguousarray(pts)).to(frames.device, non_blocking=True)
            return self._program(frames.shape[1:3])(frames, pts)

    def __call__(self, img_u8, fallback_pts=None):
        """One (H, W, 3) frame; ``fallback_pts`` an optional (2, 2) array
        (mesh mode only)."""
        if not self.mesh:
            frames = self.estimator._to_device(img_u8[None])
            return tuple(t[0] for t in self._program(frames.shape[1:3])(frames))
        pts = None if fallback_pts is None else np.asarray(fallback_pts, np.int32)[None]
        return {k: v[0] for k, v in self.batched(img_u8[None], pts).items()}


# -- packed outputs: one device→host copy ------------------------------------------------

# A frame's small outputs of a program, packed into one int32 row (float32
# fields bit-cast), in this order: (name, shape, dtype)
IRIS_FIELDS = (("boxes", (16, 16), np.float32), ("scores", (16,), np.float32), ("valid", (16,), np.bool_),
               ("mesh", (478, 2), np.int32), ("mesh_score", (), np.float32), ("l_center", (2,), np.float32),
               ("l_radius", (), np.float32), ("r_center", (2,), np.float32), ("r_radius", (), np.float32),
               ("pose_lm", (33, 5), np.float32), ("pose_score", (), np.float32),
               ("iris_sample", (), np.float32), ("fallback_sample", (), np.float32),
               ("ears_sample", (), np.float32))
DETECTION_FIELDS = (("boxes", (16, 16), np.float32), ("scores", (16,), np.float32), ("valid", (16,), np.bool_),
                    ("mesh", (478, 2), np.int32), ("pose_lm", (33, 5), np.float32), ("pose_score", (), np.float32))


def pack(out: Dict[str, torch.Tensor], fields) -> torch.Tensor:
    """The ``fields`` of a batch's outputs → (B, L) int32."""
    b = out["valid"].shape[0]
    parts = []
    for name, _shape, dtype in fields:
        t = out[name].reshape(b, -1)
        parts.append(t.contiguous().view(torch.int32) if dtype == np.float32 else t.to(torch.int32))
    return torch.cat(parts, dim=1)


def unpack(row: np.ndarray, fields) -> dict:
    """One frame's (L,) int32 row → its fields as numpy values."""
    out, i = {}, 0
    for name, shape, dtype in fields:
        n = int(np.prod(shape))
        v = row[i:i + n]
        v = v.view(np.float32) if dtype == np.float32 else v.astype(dtype)
        out[name] = v.reshape(shape) if shape else v[0]
        i += n
    return out


# -- the detection-only program (depth_by_detection.py) ---------------------------------


def make_fused_detection_frame_fn(detector, in_hw: Tuple[int, int]):
    """JAX ``make_fused_detection_frame_fn``: the detection-only pipeline's
    whole detector stack (depth_by_detection.py:196-287) as one program on B
    frames of u8 BGR already on the device, with no host sync inside →
    a dict of (B, …) tensors: ``boxes`` (16, 16), ``scores`` (16,),
    ``valid`` (16,), ``mesh`` (478, 2) int32 frame pixels (tier 1),
    ``pose_lm`` (33, 5) in 256-crop units and ``pose_score`` (tier 3).

    One BlazeFace pass (K2 linear to 128²) feeds all three tiers. JAX's
    ``lax.cond`` on ``valid[0]`` chooses FaceMesh+iris on the face crop or
    BlazePose (K2 linear to 256²); here both run and ``_keep`` keeps one,
    with JAX's zeros for the other (mesh zeros on a miss, pose zeros and
    score 0 on a hit). When ``detector.faithful`` the mesh reads the frame's
    BGR bytes /255, unswapped, as ``FaceDetector.findIris`` feeds it
    (depth_by_detection.py:67-75); otherwise the RGB frame. ``detector``
    is a ``FaceDetector``."""
    impl = detector._impl
    h, w = int(in_hw[0]), int(in_hw[1])
    feed = u8_to_01 if detector.faithful else bgr_u8_to_rgb01
    thresh = detector.minDetectionCon

    def fused(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        if tuple(frames.shape[1:3]) != (h, w):
            raise ValueError(f"frames of {tuple(frames.shape[1:3])} given to the {(h, w)} program")
        with torch.inference_mode(), full_f32():
            boxes, scores, valid = blazeface_branch(impl._face_det, impl._face_anchors, thresh, frames)
            points, _score = mesh_points(impl._mesh, frames, *crop_box(boxes, h, w), pixels=feed)
            pose_lm, pose_score = pose_branch(impl._pose, frames)
            hit = valid[:, 0]
            return {"boxes": boxes, "scores": scores, "valid": valid, "mesh": _keep(hit, to_int32(points), True),
                    "pose_lm": _keep(hit, pose_lm, False), "pose_score": _keep(hit, pose_score, False)}

    return fused


class FusedDetectionRunner:
    """Caches the detection program per source size; one program a frame for
    the three-tier pipeline. ``__call__(img_u8)`` returns host numpy
    ``(boxes, scores, valid, mesh, pose_lm, pose_score)`` through one
    device→host copy of all outputs packed in one row (JAX: one
    ``device_get``)."""

    def __init__(self, detector):
        self.detector = detector
        self._cache = {}

    def program(self, hw):
        hw = (int(hw[0]), int(hw[1]))
        if hw not in self._cache:
            self._cache[hw] = make_fused_detection_frame_fn(self.detector, hw)
        return self._cache[hw]

    def __call__(self, img_u8: np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(img_u8)[None]).to(self.detector.device)
        with torch.inference_mode():
            row = pack(self.program(img_u8.shape[:2])(frames), DETECTION_FIELDS)[0].cpu().numpy()
        out = unpack(row, DETECTION_FIELDS)
        return tuple(out[name] for name, _shape, _dtype in DETECTION_FIELDS)
