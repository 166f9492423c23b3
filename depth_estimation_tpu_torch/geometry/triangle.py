"""Pinhole-camera triangle-similarity math + unit converters (a copy of the
JAX package's ``geometry/triangle.py``).

Free-function equivalents of the helpers in the reference's detection-only
pipeline (depth_by_detection.py:127-158). All are scalar host-side math —
they run once per frame on tiny values, so they stay in Python; the fused
frame program samples depth on the device (``runtime/fused.py``).
"""

from __future__ import annotations

import math
from typing import Tuple


def mm2cm(dist: float) -> float:
    # reference: depth_by_detection.py:127-128
    return dist / 10


def cm_to_ft(dist: float) -> float:
    # reference: depth_by_detection.py:130-131 (rounds to 2 decimals)
    return round(dist / (2.54 * 12), 2)


def in_to_mm(dist: float) -> float:
    # reference: depth_by_detection.py:133-134
    return round(dist * 2.54 * 10, 2)


def diameter(radius: float) -> int:
    # reference: depth_by_detection.py:136-137 (truncates to int)
    return int(radius * 2)


def dist_euclid(pt1: Tuple[float, float], pt2: Tuple[float, float]) -> float:
    # reference: depth_by_detection.py:139-140
    return math.sqrt((pt2[0] - pt1[0]) ** 2 + (pt2[1] - pt1[1]) ** 2)


def f_length(d_2_obj: float, w_object: float, w_pix: float) -> float:
    """Focal length from a known object at a known distance.

    reference: depth_by_detection.py:142-149. Note the reference's docstring
    mislabels the roles; the formula is ``f = d * w_pix / w_object``.
    """
    return (d_2_obj * w_pix) / w_object


def s2c_dist(f: float, w_object: float, w_pix: float) -> float:
    """Subject-to-camera distance (mm) by triangle similarity.

    reference: depth_by_detection.py:151-158.
    """
    return (f * w_object) / w_pix
