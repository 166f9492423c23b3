"""Minimum enclosing circle (cv2.minEnclosingCircle equivalent), JAX
``detect/circle.py``.

The reference fits circles to the 4 iris landmarks of each eye
(detectors.py:63-64). Two implementations:

* ``min_enclosing_circle`` — exact host-side solver for small point sets
  (candidate enumeration over all pairs and triples), a numpy copy;
* ``min_enclosing_circle_torch`` — the same enumeration as tensor ops over a
  batch of point sets, so that the fused frame program fits both iris
  circles on the device (JAX ``min_enclosing_circle_jax``).
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

_EPS = 1e-9


def _circumcircle(p1, p2, p3):
    ax, ay = p1
    bx, by = p2
    cx, cy = p3
    d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
    if abs(d) < _EPS:
        return None
    ux = ((ax * ax + ay * ay) * (by - cy) + (bx * bx + by * by) * (cy - ay) + (cx * cx + cy * cy) * (ay - by)) / d
    uy = ((ax * ax + ay * ay) * (cx - bx) + (bx * bx + by * by) * (ax - cx) + (cx * cx + cy * cy) * (bx - ax)) / d
    r = float(np.hypot(ax - ux, ay - uy))
    return (float(ux), float(uy)), r


def min_enclosing_circle(points: Sequence[Sequence[float]]) -> Tuple[Tuple[float, float], float]:
    """Exact minimum enclosing circle of ≤ a few dozen 2D points."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        raise ValueError("need at least one point")
    if n == 1:
        return (float(pts[0, 0]), float(pts[0, 1])), 0.0

    best: Tuple[Tuple[float, float], float] | None = None

    def contains_all(c, r):
        return np.all(np.hypot(pts[:, 0] - c[0], pts[:, 1] - c[1]) <= r + 1e-7)

    for i in range(n):
        for j in range(i + 1, n):
            c = ((pts[i, 0] + pts[j, 0]) / 2, (pts[i, 1] + pts[j, 1]) / 2)
            r = float(np.hypot(pts[i, 0] - pts[j, 0], pts[i, 1] - pts[j, 1]) / 2)
            if contains_all(c, r) and (best is None or r < best[1]):
                best = (c, r)
    if best is None:
        for i in range(n):
            for j in range(i + 1, n):
                for k in range(j + 1, n):
                    cc = _circumcircle(pts[i], pts[j], pts[k])
                    if cc is None:
                        continue
                    c, r = cc
                    if contains_all(c, r) and (best is None or r < best[1]):
                        best = (c, r)
    assert best is not None
    (cx, cy), r = best
    return (cx, cy), r


def min_enclosing_circle_torch(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MEC of each set of a fixed small N points: points (..., N, 2)
    → (center (..., 2), radius (...)), branch-free.

    Enumerates the pair-diameter and the triple-circumcircle candidates (in
    the JAX function's order), masks those that miss a point, with f32's
    slack: a point counts as inside within radius·(1 + 1e-4) + 1e-5, and
    takes the first candidate of least radius. A degenerate triple's radius
    is inf."""
    pts = points.to(torch.float32)
    n = pts.shape[-2]
    pairs = list(itertools.combinations(range(n), 2))
    ii, jj = (torch.tensor(c, device=pts.device) for c in zip(*pairs))
    centers = (pts[..., ii, :] + pts[..., jj, :]) / 2.0
    radii = torch.linalg.vector_norm(pts[..., ii, :] - pts[..., jj, :], dim=-1) / 2.0
    triples = list(itertools.combinations(range(n), 3))
    if triples:
        a, b, c = (pts[..., torch.tensor(t, device=pts.device), :] for t in zip(*triples))
        ax, ay, bx, by, cx, cy = a[..., 0], a[..., 1], b[..., 0], b[..., 1], c[..., 0], c[..., 1]
        d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
        degenerate = torch.abs(d) < _EPS
        d_safe = torch.where(degenerate, 1.0, d)
        a2, b2, c2 = (a * a).sum(-1), (b * b).sum(-1), (c * c).sum(-1)
        ux = (a2 * (by - cy) + b2 * (cy - ay) + c2 * (ay - by)) / d_safe
        uy = (a2 * (cx - bx) + b2 * (ax - cx) + c2 * (bx - ax)) / d_safe
        tc = torch.stack([ux, uy], dim=-1)
        tr = torch.where(degenerate, torch.inf, torch.linalg.vector_norm(a - tc, dim=-1))
        centers = torch.cat([centers, tc], dim=-2)
        radii = torch.cat([radii, tr], dim=-1)
    dist = torch.linalg.vector_norm(centers[..., :, None, :] - pts[..., None, :, :], dim=-1)
    inside = (dist <= radii[..., None] * (1.0 + 1e-4) + 1e-5).all(dim=-1)
    radii = torch.where(inside, radii, torch.inf)
    best = torch.argmin(radii, dim=-1, keepdim=True)  # the first of equal minima, as jnp.argmin
    center = torch.gather(centers, -2, best[..., None].expand(*best.shape, 2))[..., 0, :]
    return center, torch.gather(radii, -1, best)[..., 0]
