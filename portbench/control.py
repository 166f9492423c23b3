"""The control of the correctness check: the reference put in the program's
place and computed one precision lower, TF32 where the configuration
states float32, on the maps a run compares (the same frames, the same
count, at the cell's own size). Its reading has to fail the cell's limit.

    python3 portbench/control.py --workload dpt_large.serve_poisson --seeds 1 2 3

prints one JSON line a seed: the control's reading, the limit, and the
range of the reference's maps. ``tests/test_portbench_control.py`` runs
it on the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List

import torch


def readings(spec, workload: str, seeds: List[int], device="cuda", seconds: float = 20.0) -> List[Dict]:
    from portbench import compare, schedule
    from portbench import spec as specs
    from portbench.frames import Frames
    from portbench.harness import Run
    from portbench.reference import frame as ref
    from portbench.weights import make_weights

    out = []
    for seed in seeds:
        run = Run(spec, workload, seed, seconds, trace=False, device=device)
        due = schedule.arrivals(run.traffic["arrivals"], seconds, seed)
        idx = sorted(run.sample(len(due) if due is not None else 1000))
        frames = torch.from_numpy(Frames(seed, run.config["input_hw"], run.device).stack(idx)).to(run.device)
        model = ref.build_model(run.config, make_weights(run.config, seed, run.device), run.device)
        want = ref.depth_maps(model, frames, run.config, tf32=False)
        low = ref.depth_maps(model, frames, run.config, tf32=True)
        u8 = run.traffic.get("output", "u8") == "u8"
        gap = max(compare.u8_gap(ref.wraparound_u8(lo), w) if u8 else compare.max_scaled_err(lo, w)
                  for lo, w in zip(low, want))
        out.append({"workload": workload, "seed": seed, "compare": "u8_gap" if u8 else "max_scaled_err",
                    "control": gap, "limit": specs.limits(workload)["limit"], "maps": len(idx),
                    "ref_min": float(want.min()), "ref_max": float(want.max()),
                    "ref_mean": float(want.mean()), "ref_zero_share": float((want == 0).double().mean())})
        del model, want, low
    return out


def main(argv=None) -> int:
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from portbench.spec import Spec

    p = argparse.ArgumentParser(description="control readings of a cell's correctness check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for r in readings(Spec(root), args.workload, args.seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
