"""How a served map is held against the reference's.

Both numbers are per frame, scaled by the largest magnitude of the
reference's map for that frame, and a run reports the worst frame.

* ``max_scaled_err``: an f32 map, max |got - want| / max |want|.
* ``u8_gap``: a u8 map (the reference's wrap-around cast of the depth,
  made by the program). For each pixel, the distance from the reference's
  f32 value to the nearest value whose cast gives the byte that was served:
  0 where the byte is the reference's own, and about the f32 error where
  rounding moved the value across an integer. A byte that is wrong by more
  than rounding reads as far as the value would have to move.
"""

from __future__ import annotations

import torch


def max_scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().amax() / want.abs().amax().clamp_min(1e-30))


def _trunc_preimage_distance(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Distance from v to {x : trunc(x) == n}: [n, n+1) for n > 0, (-1, 1)
    for n == 0, (n-1, n] for n < 0 (closed, to within one ulp)."""
    lo = torch.where(n > 0, n, n - 1)
    hi = torch.where(n >= 0, n + 1, n)
    return torch.clamp(lo - v, min=0) + torch.clamp(v - hi, min=0)


def u8_gap(got_u8: torch.Tensor, want: torch.Tensor) -> float:
    v = want.double()
    u = got_u8.to(torch.float64)
    n0 = torch.trunc(v)
    up = n0 + torch.remainder(u - n0, 256)  # the nearest integer >= trunc(v) that casts to u
    dist = torch.minimum(_trunc_preimage_distance(v, up), _trunc_preimage_distance(v, up - 256))
    return float(dist.amax() / v.abs().amax().clamp_min(1e-30))
