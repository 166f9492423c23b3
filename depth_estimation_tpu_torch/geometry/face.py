"""FaceDet — camera calibration + triangle-similarity geometry state.

A copy of the JAX package's ``geometry/face.py`` (numpy only), so that the
port imports nothing of that package.

Behavioral re-implementation of the reference's ``FaceDet`` (face.py:4-168):
calibrates a pinhole focal length from credit-card endpoints, converts iris /
head pixel widths into metric subject-to-camera distance, samples the depth
map at the iris centers, fits relative→absolute depth, and tracks RMSE/MAE.

Faithful-behavior notes (all reproduced here when ``faithful=True``, the
default, and fixed when ``faithful=False``):

* ``get_depth`` indexes the depth map as ``img[x, y]`` — i.e. with the
  (x, y) pixel coordinates *transposed* relative to numpy's (row, col)
  convention (face.py:106-107).
* The clamping loop overwrites ``l_ctr[1]`` with the clamp of ``r_ctr[1]``
  and never clamps ``r_ctr[1]`` itself (face.py:101-105).
* ``rel2abs`` "converts" relative inverse depth to absolute feet by a bare
  division by 2.54 (face.py:132-139).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from depth_estimation_tpu_torch.geometry import triangle


class FaceDet:
    """Holds per-subject calibration, measurements and running error stats.

    Initialisation computes the camera focal length from the pixel distance
    between two known credit-card endpoints (``points = (x1, y1, x2, y2)``)
    observed at a known distance ``d_2_obj`` (inches). reference: face.py:15-26.
    """

    # credit card width, mm (reference: face.py:17)
    w_card: float = 85.6
    # mean human iris diameter, mm (reference: face.py:19)
    w_iris: float = 11.7

    def __init__(self, d_2_obj: float, points: Sequence[float], faithful: bool = True):
        self.faithful = faithful
        # pixel distance between the card endpoints (x1,y1)-(x2,y2)
        # (reference computes math.dist(points[:2], points[2:]), face.py:22)
        self.w_pix = math.dist(tuple(points[:2]), tuple(points[2:]))
        self.d_2_obj = self.in_to_mm(d_2_obj)
        self.f = self.f_length()

        self.l_iris: Dict[str, Optional[object]] = {"center": None, "radius": None}
        self.r_iris: Dict[str, Optional[object]] = {"center": None, "radius": None}
        self.mesh: Optional[np.ndarray] = None
        self.head_pts: Optional[Tuple] = None
        self.head_w: float = 0
        self.head_measurements: List[float] = []
        self.s2c_d: float = 0
        self.s2c_ds: List[float] = []
        self.ri_depth: float = 0
        self.ri_depths: List[float] = []
        self.abs_depth: float = 0
        self.abs_depths: List[float] = []
        self.error: float = 0
        self.errors: List[float] = []

    # -- calibration ------------------------------------------------------

    def f_length(self) -> float:
        """Focal length by triangle similarity (reference: face.py:51-59)."""
        return (self.d_2_obj * self.w_pix) / self.w_card

    # -- distance ---------------------------------------------------------

    def s2c_dist(self, w_object: float, w_pix: float) -> None:
        """Subject-to-camera distance; logs cm, reports ft (face.py:61-76)."""
        d_mm = (self.f * w_object) / w_pix
        d_cm = d_mm / 10
        self.s2c_ds.append(d_cm)
        self.s2c_d = self.cm_to_ft(d_cm)

    def get_headw(self, p1: Sequence[float], p2: Sequence[float]) -> None:
        """Head width (mm) from cheek points scaled by iris size (face.py:78-89)."""
        self.head_pts = (p1, p2)
        head_pixw = math.dist((p1[0], p1[1]), (p2[0], p2[1]))
        self.head_w = (head_pixw * self.w_iris) / (self.l_iris["radius"] * 2)
        self.head_measurements.append(self.head_w)

    # -- depth sampling ----------------------------------------------------

    def get_depth(self, img: np.ndarray) -> None:
        """Mean relative inverse depth at the two iris centers (face.py:91-116).

        When no mesh is present, falls back to sampling at the stored body
        head points (face.py:111-116).
        """
        if self.mesh is not None:
            lx, ly = (int(v) for v in self.l_iris["center"])
            rx, ry = (int(v) for v in self.r_iris["center"])
            if self.faithful:
                # Quirk-compatible clamping (face.py:99-105): x components are
                # clamped to shape[0]-1; l's y slot ends up holding the clamp
                # of *r*'s y; r's y is never clamped. Indexing is img[x, y].
                lx = min(img.shape[0] - 1, lx)
                rx = min(img.shape[0] - 1, rx)
                ly = min(img.shape[1] - 1, ry)
                left = img[lx, ly]
                right = img[rx, ry]
            else:
                h, w = img.shape[:2]
                left = img[min(h - 1, ly), min(w - 1, lx)]
                right = img[min(h - 1, ry), min(w - 1, rx)]
            ri_depth = (left + right) / 2
        else:
            if self.faithful:
                d_left = img[self.head_pts[0][0], self.head_pts[0][1]]
                d_right = img[self.head_pts[1][0], self.head_pts[1][1]]
            else:
                d_left = img[self.head_pts[0][1], self.head_pts[0][0]]
                d_right = img[self.head_pts[1][1], self.head_pts[1][0]]
            ri_depth = (d_left + d_right) / 2
        self.record_depth(ri_depth)

    def record_depth(self, ri_depth: float) -> None:
        """Record an already-sampled relative-inverse-depth value (the tail
        of get_depth, face.py:115-116). The fused single-dispatch pipeline
        samples the map on the device (runtime/fused.py::_sample_iris_depth)
        and records the scalar here — identical state mutation, no f32 map
        fetch."""
        self.ri_depth = ri_depth
        self.ri_depths.append(ri_depth)

    # -- relative -> absolute ----------------------------------------------

    def rel2abs_2(self, pred_depths: Sequence[float], gt_depths: Sequence[float]) -> None:
        """Least-squares fit ``pred = m·(1/gt) + b``; sets abs depth in ft.

        reference: face.py:118-130.
        """
        gt = [1 / x for x in gt_depths]
        A = np.vstack([gt, np.ones(len(gt))]).T
        self.m, self.b = np.linalg.lstsq(A, np.asarray(pred_depths), rcond=None)[0]
        self.abs_depth = self.cm_to_ft(self.ri_depth * self.m + self.b)

    def rel2abs(self) -> None:
        """Naive linear transform (divide by 2.54) — reference: face.py:132-139."""
        self.abs_depth = self.ri_depth / 2.54
        self.abs_depths.append(self.abs_depth)

    # -- error metrics ------------------------------------------------------

    def rmse(self) -> float:
        """RMSE of (s2c cm distances, converted abs depths) pairs (face.py:141-146)."""
        sq = [(s - a) ** 2 for s, a in zip(self.s2c_ds, self.abs_depths)]
        return math.sqrt(sum(sq) / len(sq))

    def mae(self) -> float:
        """MAE of the same pairs (face.py:148-153)."""
        ae = [abs(s - a) for s, a in zip(self.s2c_ds, self.abs_depths)]
        return sum(ae) / len(ae)

    # -- unit converters (reference: face.py:155-168) -----------------------

    def mm2cm(self, dist: float) -> float:
        return dist / 10

    def cm_to_ft(self, dist: float) -> float:
        return round(dist / (2.54 * 12), 2)

    def in_to_mm(self, dist: float) -> float:
        return round(dist * 2.54 * 10, 2)

    def diameter(self, radius: float) -> int:
        return int(radius * 2)

    def dist_euclid(self, pt1: tuple, pt2: tuple) -> float:
        return triangle.dist_euclid(pt1, pt2)
