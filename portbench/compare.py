"""How a served output is held against the reference's.

A cell's limits (``limits/<cell>.json``) name, for each field of what the
program serves a frame, the comparison below that judges it, its limit and
any arguments the comparison takes (``"args"``). A file with a single
``"compare"`` and ``"limit"`` judges the one depth map a frame, the field
``depth``, and its check keeps the comparison's bare name (``fields``).

Each number is per frame, and a run reports the worst frame:

* ``max_scaled_err``: an f32 output, max |got - want| / max |want|, scaled
  by the largest magnitude of the reference's value for that frame.
* ``u8_gap``: a u8 map (the reference's wrap-around cast of the depth,
  made by the program). For each pixel, the distance from the reference's
  f32 value to the nearest value whose cast gives the byte that was served:
  0 where the byte is the reference's own, and about the f32 error where
  rounding moved the value across an integer. A byte that is wrong by more
  than rounding reads as far as the value would have to move. Scaled as
  ``max_scaled_err``.
* ``trunc_gap``: an int that is the truncation toward zero of a float (a
  pixel coordinate, a landmark). For each element, the distance from the
  reference's float to the set of floats that truncate to the served int:
  0 where the int is the reference's own truncation, about the f32 error
  where rounding crossed an integer, and about 1 for an int one past it.
  In the int's own units, not scaled: an int is wrong by whole units.
* ``flag_gap``: a flag that says whether a score lies above ``threshold``
  (a detection's validity). For each element, 0 where the served flag is
  the reference's ``want > threshold``, and otherwise the distance from the
  reference's score to the threshold: about the f32 error where the score
  lies on it, as far as the score lies from it where the flag is wrong. In
  the score's own units, not scaled.

``served`` turns a reference value into what the program serves under a
comparison (the control serves the reference in the program's place).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.frame import DEPTH, wraparound_u8


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


def trunc_gap(got_int: torch.Tensor, want: torch.Tensor) -> float:
    if not want.numel():
        return 0.0
    return float(_trunc_preimage_distance(want.double(), got_int.to(torch.float64)).amax())


def flag_gap(got_flag: torch.Tensor, want: torch.Tensor, threshold: float) -> float:
    v = want.double()
    wrong = got_flag.bool() != (v > threshold)
    return float(torch.where(wrong, (v - threshold).abs(), torch.zeros_like(v)).amax()) if v.numel() else 0.0


def served(compare: str, want: torch.Tensor, **args) -> torch.Tensor:
    """What the program serves for the reference's value ``want`` under
    comparison ``compare``: the value itself, its wrap-around u8 cast, its
    truncation or its flag."""
    if compare == "max_scaled_err":
        return want
    if compare == "u8_gap":
        return wraparound_u8(want)
    if compare == "trunc_gap":
        return torch.trunc(want.double()).to(torch.int64)
    if compare == "flag_gap":
        return want > args["threshold"]
    raise ValueError(f"no comparison {compare!r}")


def fields(limits: Dict) -> Dict[str, Dict]:
    """A cell's limits by output field: ``{field: {"compare", "limit",
    "args", "key"}}``, ``key`` the name its check is reported under
    (``<field>.<compare>``; the bare comparison's name for a file that
    judges the depth map alone)."""
    if "fields" not in limits:
        return {DEPTH: {"compare": limits["compare"], "limit": float(limits["limit"]), "args": {},
                        "key": limits["compare"]}}
    out = {}
    for name, f in limits["fields"].items():
        if f["compare"] not in COMPARISONS:
            raise ValueError(f"field {name}: no comparison {f['compare']!r}")
        out[name] = {"compare": f["compare"], "limit": float(f["limit"]), "args": dict(f.get("args", {})),
                     "key": f"{name}.{f['compare']}"}
    return out


def worst_gaps(limits: Dict[str, Dict], got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               worst: Dict[str, float]) -> None:
    """Raise ``worst[key]`` (0 to start with) of each field of ``limits``,
    as ``fields`` gives them, to its worst frame in a block; ``got`` and
    ``want`` hold each field's values stacked over the block's frames. A
    gap that is not finite reads as infinite."""
    for name, f in limits.items():
        fn = COMPARISONS[f["compare"]]
        for g, w in zip(got[name], want[name]):
            gap = fn(g, w, **f["args"])
            worst[f["key"]] = max(worst[f["key"]], gap if math.isfinite(gap) else math.inf)


COMPARISONS = {"max_scaled_err": max_scaled_err, "u8_gap": u8_gap, "trunc_gap": trunc_gap, "flag_gap": flag_gap}
