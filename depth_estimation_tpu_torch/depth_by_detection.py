"""Detection-only distance pipeline, mirroring the reference's
depth_by_detection.py (public surface: FaceDetector, the free geometry
helpers, main()).

Three-tier fallback (depth_by_detection.py:161-297): FaceMesh iris → face
bbox + median head width → body pose, with distance from triangle
similarity only. By default one detection program a frame
(``runtime/fused.py::FusedDetectionRunner``) feeds all three tiers;
``--staged`` runs each detector net as its own program. ``--with-depth
MODEL`` also runs a depth net on tier-2 frames and reports the median
relative inverse depth inside each face box, reduced on the device. The
calibration uses w_object=82.6, a reference inconsistency with face.py's
85.6 that is kept (SURVEY.md §2a C4).

Weights load from the cache ($DEPTH_ESTIMATION_TPU_TORCH_CACHE, default
~/.cache/depth_estimation_tpu_torch): the detector nets' from the MediaPipe
.tflite files staged by ``tools.import_weights --tflite FILE...``, the
``--with-depth`` net's from ``tools.import_weights <ckpt.pt> <model_type>``.
A net with nothing cached runs on random weights, with a warning.

Usage:
    python -m depth_estimation_tpu_torch.depth_by_detection [--src VIDEO|synthetic:NxHxW]
        [--output out.avi] [--quiet] [--with-depth MODEL] [--staged] [--trace [DIR]]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
from statistics import median

import numpy as np

from depth_estimation_tpu_torch.detect.circle import min_enclosing_circle
from depth_estimation_tpu_torch.detect.face_detector import FaceDetector
from depth_estimation_tpu_torch.geometry.triangle import (  # noqa: F401
    cm_to_ft,
    diameter,
    dist_euclid,
    f_length,
    in_to_mm,
    mm2cm,
    s2c_dist,
)
from depth_estimation_tpu_torch.ops.sampling import rois_median_depth
from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner
from depth_estimation_tpu_torch.runtime.tracing import DEFAULT_DIR, maybe_trace
from depth_estimation_tpu_torch.runtime.video import open_sink, open_source

# face mesh indices (reference: depth_by_detection.py:176-185)
LEFT_EYE = [362, 382, 381, 380, 374, 373, 390, 249, 263, 466, 388, 387, 386, 385, 384, 398]
RIGHT_EYE = [33, 7, 163, 144, 145, 153, 154, 155, 133, 173, 157, 158, 159, 160, 161, 246]
LEFT_IRIS = [474, 475, 476, 477]
RIGHT_IRIS = [469, 470, 471, 472]
HEAD = [234, 454, 10, 152]
BODY_HEAD = [7, 8]
CARD = [505, 504, 675, 501]


def _put_text(img, text, org, color, scale=1, thick=2):
    try:
        import cv2

        cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, thick, cv2.LINE_AA)
    except ImportError:
        pass


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--src", default="synthetic:30x480x640",
                        help="video path, camera index, or synthetic:<n>x<H>x<W>")
    parser.add_argument("--output", default="output.avi")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--with-depth", metavar="MODEL", default=None,
                        help="also run a depth net (e.g. MiDaS_small) and report the median relative inverse "
                             "depth inside each detector box (reduced on the device)")
    parser.add_argument("--staged", action="store_true",
                        help="run each detector net as its own program instead of one detection program a frame")
    parser.add_argument("--trace", nargs="?", const=DEFAULT_DIR, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run (Chrome trace format) into DIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = parser.parse_args(argv)

    estimator = None
    if args.with_depth:
        from depth_estimation_tpu_torch.estimator import DepthEstimator

        estimator = DepthEstimator(args.with_depth, verbose=not args.quiet, device=args.device)

    video = open_source(args.src)
    print(f"Frame count: {video.frame_count}")
    if not video.is_opened():
        print("Error opening file")
    w, h = int(video.width), int(video.height)
    writer = open_sink(args.output, (w, h), fps=20)

    detector = FaceDetector(device=args.device)
    runner = None if args.staged else FusedDetectionRunner(detector)

    # calibration from credit-card test footage (depth_by_detection.py:190-192)
    w_pix = dist_euclid((CARD[0], CARD[2]), (CARD[1], CARD[3]))
    d_2_obj = in_to_mm(20)
    f = f_length(d_2_obj, w_object=82.6, w_pix=w_pix)
    head_measurements = []

    try:
        import cv2
    except ImportError:
        cv2 = None

    with contextlib.ExitStack() as stack:
        # stop the profiler and release IO even if the loop raises
        stack.callback(writer.release)
        stack.callback(video.release)
        tdir = stack.enter_context(maybe_trace(args.trace is not None, args.trace))
        _loop(args, video, writer, detector, runner, estimator, f, head_measurements, cv2)
    if tdir:
        print(f"Trace written to {tdir}")


def _loop(args, video, writer, detector, runner, estimator, f, head_measurements, cv2):
    cnt = 0
    w_real = 11.7  # standard iris diameter, mm
    while video.is_opened():
        cnt += 1
        if not args.quiet:
            print(f"Frame: {cnt} Width: {video.width}\t Height: {video.height}")
        success, img = video.read()
        if not success:
            print("No access to video feed. Exiting...")
            break
        if runner is not None:
            # the whole detector stack is one program; all three tiers feed off its outputs
            f_boxes, f_scores, f_valid, f_mesh, f_plm, f_pscore = runner(img)
            detection = (f_boxes, f_scores, f_valid)
            found = bool(np.asarray(f_valid)[0])
            mesh_points = np.asarray(f_mesh) if found else None
            fused_pose = (f_plm, f_pscore) if not found else None
        else:
            mesh_points = detector.findIris(img)
            detection = None
            fused_pose = None
        if mesh_points is not None:
            _r = min_enclosing_circle(mesh_points[LEFT_IRIS])[1]
            _hw = dist_euclid(tuple(mesh_points[HEAD[0]]), tuple(mesh_points[HEAD[1]]))
            if _r <= 0 or _hw <= 0:
                # degenerate iris fit or coincident head points: a miss, so the
                # detection tiers follow instead of a division by zero
                mesh_points = None
        # TIER 1 — iris landmarks (depth_by_detection.py:202-250)
        if mesh_points is not None:
            if cv2 is not None:
                cv2.polylines(img, [mesh_points[LEFT_EYE]], True, (0, 255, 0), 1, cv2.LINE_AA)
                cv2.polylines(img, [mesh_points[RIGHT_EYE]], True, (0, 255, 0), 1, cv2.LINE_AA)
            (l_cx, l_cy), l_radius = min_enclosing_circle(mesh_points[LEFT_IRIS])
            (r_cx, r_cy), r_radius = min_enclosing_circle(mesh_points[RIGHT_IRIS])
            if cv2 is not None:
                cv2.circle(img, np.array([l_cx, l_cy], dtype=np.int32), int(l_radius), (255, 0, 255), 2, cv2.LINE_AA)
                cv2.circle(img, np.array([r_cx, r_cy], dtype=np.int32), int(r_radius), (255, 0, 255), 2, cv2.LINE_AA)
                cv2.line(img, mesh_points[HEAD[0]], mesh_points[HEAD[1]], (0, 255, 0), 1, cv2.LINE_AA)
                cv2.line(img, mesh_points[HEAD[2]], mesh_points[HEAD[3]], (0, 255, 0), 1, cv2.LINE_AA)

            l_diameter = l_radius * 2
            s2c_d = cm_to_ft(s2c_dist(f, w_real, l_diameter) / 10)

            x1, y1 = mesh_points[HEAD[0]]
            x2, y2 = mesh_points[HEAD[1]]
            head_pixw = dist_euclid((x1, y1), (x2, y2))
            pix_dist = w_real / l_diameter
            head_w_mm = (head_pixw * w_real) / l_diameter
            head_measurements.append(head_w_mm)
            s2c_d2 = cm_to_ft(s2c_dist(f, head_w_mm, head_pixw) / 10)

            messages = [
                f"S2C Distance (ft) - iris: {str(s2c_d)}",
                f"S2C Distance (ft) - head: {str(s2c_d2)}",
                f"Head width (in): {str(round((head_w_mm / 10) / 2.54, 2))}",
                f"head_w_mm: {str(head_w_mm)}",
                f"focal length: {round(f, 2)}",
                f"mm / pixel - iris plane: {pix_dist}",
            ]
            for idx, m in enumerate(messages):
                _put_text(img, m, (50, 50 + idx * 50), (0, 255, 0))
            writer.write(img)
        else:
            # TIER 2 — face bbox + median head width (depth_by_detection.py:252-274)
            _put_text(img, "Landmarks not detected. Using face boundaries.", (70, 50), (255, 0, 0))
            img, bboxes = detector.findFaces(img, detection=detection)
            if estimator is not None and bboxes:
                # the median relative inverse depth inside each box, on the device
                depth_map = estimator.predict_device(img)
                boxes_yxyx = np.array(
                    [[b["bbox"][1], b["bbox"][0], b["bbox"][1] + b["bbox"][3], b["bbox"][0] + b["bbox"][2]]
                     for b in bboxes], np.int32,
                )
                meds = rois_median_depth(depth_map, boxes_yxyx, np.ones(len(bboxes), bool)).cpu().numpy()
                for b, med in zip(bboxes, meds):
                    b["roi_median_depth"] = float(med)
                    _put_text(img, f"ROI median ri-depth: {round(float(med), 2)}",
                              (b["bbox"][0], max(20, b["bbox"][1] - 40)), (0, 255, 255), scale=0.6, thick=1)
            if head_measurements and bboxes:
                head_w_mm = median(head_measurements)
                for box in bboxes:
                    w_pix_box = box["bbox"][2]
                    print(box["bbox"])  # reference: depth_by_detection.py:263
                    if w_pix_box <= 0:
                        continue
                    s2c_d = cm_to_ft(s2c_dist(f, w_object=head_w_mm, w_pix=w_pix_box) / 10)
                    messages = [
                        f"Frame: {cnt}",
                        f"S2C dist (ft): {s2c_d}",
                        f"head w in pixels: {w_pix_box}",
                        f"actual head w (mm): {head_w_mm}",
                    ]
                    for idx, m in enumerate(messages):
                        _put_text(img, m, (50, 100 + idx * 50), (0, 255, 0))
                writer.write(img)
            else:
                # TIER 3 — body pose (depth_by_detection.py:276-287)
                _put_text(img, "Face not detected. Using body pose estimates.", (70, 100), (255, 0, 0))
                if fused_pose is not None:  # BlazePose already ran in the detection program
                    img, head_pts = detector.body_from_fused(img, *fused_pose)
                else:
                    img, head_pts = detector.findBody(img)
                if head_measurements and len(head_pts) >= 2 and np.linalg.norm(head_pts[0] - head_pts[1]) > 0:
                    s2c_d3 = cm_to_ft(
                        s2c_dist(f, median(head_measurements), float(np.linalg.norm(head_pts[0] - head_pts[1]))) / 10
                    )
                    _put_text(img, f"S2C dist (ft): {s2c_d3}", (50, 150), (0, 255, 0))
                writer.write(img)


if __name__ == "__main__":
    main()
