"""The port's geometry (``FaceDet`` and ``triangle``) against the JAX
package's ``depth_estimation_tpu.geometry`` on the same inputs, rtol 1e-12."""

import math

import numpy as np
import pytest

from depth_estimation_tpu.geometry import triangle as jtri
from depth_estimation_tpu.geometry.face import FaceDet as JaxFaceDet
from depth_estimation_tpu_torch.config import CARD
from depth_estimation_tpu_torch.geometry import triangle as ttri
from depth_estimation_tpu_torch.geometry.face import FaceDet

RTOL = 1e-12


def _pair(faithful=True, d=20, card=CARD):
    return JaxFaceDet(d, card, faithful=faithful), FaceDet(d, card, faithful=faithful)


def _assert_state(a, b):
    for key in ("w_pix", "d_2_obj", "f", "head_w", "s2c_d", "ri_depth", "abs_depth"):
        np.testing.assert_allclose(getattr(b, key), getattr(a, key), rtol=RTOL, err_msg=key)
    for key in ("head_measurements", "s2c_ds", "ri_depths", "abs_depths"):
        np.testing.assert_allclose(getattr(b, key), getattr(a, key), rtol=RTOL, err_msg=key)
    assert a.head_pts == b.head_pts


@pytest.mark.parametrize("d,card", [(20, CARD), (35.5, (0, 0, 3, 4)), (12, (640.5, 10.25, 1.0, 470.0))])
def test_calibration_matches_jax(d, card):
    a, b = _pair(d=d, card=card)
    _assert_state(a, b)
    assert (b.w_card, b.w_iris) == (a.w_card, a.w_iris) == (85.6, 11.7)


@pytest.mark.parametrize("fn,args", [
    ("mm2cm", (123.4,)), ("cm_to_ft", (187.3,)), ("in_to_mm", (20,)), ("diameter", (3.7,)),
    ("dist_euclid", ((1.5, 2.0), (7.0, -3.25))), ("f_length", (508.0, 85.6, 170.03)),
    ("s2c_dist", (998.2, 11.7, 14.0))])
def test_triangle_functions_match_jax(fn, args):
    want, got = getattr(jtri, fn)(*args), getattr(ttri, fn)(*args)
    assert type(got) is type(want)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_unit_converters_match_jax():
    a, b = _pair()
    for fn, v in (("mm2cm", 77.7), ("cm_to_ft", 180.0), ("in_to_mm", 19.5), ("diameter", 2.6),
                  ("dist_euclid", ((0, 0), (3, 4)))):
        args = v if isinstance(v, tuple) else (v,)
        np.testing.assert_allclose(getattr(b, fn)(*args), getattr(a, fn)(*args), rtol=RTOL)


def _drive(face, depth, rng_seed):
    """One sequence of the stream's calls: iris-path distance, head width,
    iris sampling, the body fallback's sampling, rel2abs and the errors."""
    rng = np.random.default_rng(rng_seed)
    face.l_iris = {"center": (float(rng.uniform(0, 200)), float(rng.uniform(0, 300))), "radius": 4.75}
    face.r_iris = {"center": (float(rng.uniform(0, 200)), float(rng.uniform(0, 300))), "radius": 5.25}
    face.mesh = np.zeros((478, 2), int)
    face.s2c_dist(face.w_iris, face.l_iris["radius"] * 2)
    face.get_headw((17, 40), (101, 44))
    face.get_depth(depth)
    face.rel2abs()
    face.mesh = None
    face.get_depth(depth)  # samples at the stored head points
    face.rel2abs()
    face.record_depth(3.5)
    face.rel2abs()
    return face.rmse(), face.mae()


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_facedet_sequence_matches_jax(faithful, seed):
    depth = np.random.default_rng(9).random((240, 320)).astype(np.float32) * 40
    a, b = _pair(faithful=faithful)
    want, got = _drive(a, depth, seed), _drive(b, depth, seed)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    _assert_state(a, b)


def test_get_depth_clamps_as_jax_near_the_border():
    """The faithful quirks: x clamped to shape[0] - 1, the left y slot
    holding the clamp of the right y, ``img[x, y]``."""
    depth = np.arange(60 * 80, dtype=np.float32).reshape(60, 80)
    a, b = _pair()
    for face in (a, b):
        face.mesh = np.zeros((478, 2), int)
        face.l_iris = {"center": (75.9, 3.2), "radius": 1.0}
        face.r_iris = {"center": (70.1, 79.99), "radius": 1.0}
        face.get_depth(depth)
    assert b.ri_depth == a.ri_depth and b.ri_depths == a.ri_depths


def test_rel2abs_2_matches_jax():
    a, b = _pair()
    for face in (a, b):
        face.ri_depth = 2.5
        face.rel2abs_2([1.0, 2.0, 4.0], [30.0, 60.0, 90.0])
    np.testing.assert_allclose((b.m, b.b, b.abs_depth), (a.m, a.b, a.abs_depth), rtol=RTOL)
    assert math.isfinite(b.abs_depth)
