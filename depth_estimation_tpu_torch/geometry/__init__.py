from depth_estimation_tpu_torch.geometry.face import FaceDet
from depth_estimation_tpu_torch.geometry.triangle import (
    cm_to_ft,
    diameter,
    dist_euclid,
    f_length,
    in_to_mm,
    mm2cm,
    s2c_dist,
)

__all__ = [
    "FaceDet",
    "f_length",
    "s2c_dist",
    "mm2cm",
    "cm_to_ft",
    "in_to_mm",
    "diameter",
    "dist_euclid",
]
